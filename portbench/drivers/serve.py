"""Serving traffic: one client in a closed loop, each request
``inference.run_inference(task, {"x": images}, seed=<request seed>)`` with
a batch of float32 NHWC images as numpy, returning numpy.

The request images are a pool of distinct batches made from the run's seed
in set-up; request i sends pool entry i mod the pool's size with its own
noise seed. Set-up warms the request shape with a few requests. The window
times every request from its call to its numpy return; a sample of the
requests, drawn from the seed (and the window's first), keeps its
answer. After the window the
program is released and the reference recomputes each kept answer: the
generator forward in float32 with the noise of the request's seed, clipped
to [0, 1].
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import time
from pathlib import Path
from typing import Dict

import torch

from portbench import trace, weights
from portbench.drivers.train import build_task
from portbench.harness import sub_seed
from portbench.reference.nets import F32, Precision
from portbench.reference.steps import family


def request_seed(seed: int, i: int) -> int:
    return (sub_seed(seed, 3) * 1_000_003 + i) % 2 ** 62


class Cell:
    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 scratch: Path, log=print):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.p = cell["params"]
        self.device = torch.device(device)
        self.scratch, self.log = scratch, log
        self.kept: Dict[int, object] = {}
        self.next = 0
        self.request_seed = request_seed

    def setup(self) -> None:
        from vae_cyclegan_tpu_torch.inference import run_inference

        self.run_inference = run_inference
        s, b = self.cfg["image_size"], self.p["batch_size"]
        gen = torch.Generator(self.device).manual_seed(sub_seed(self.seed, 1))
        pool = torch.rand((self.p["pool"], b, s, s, 3), generator=gen,
                          device=self.device)
        self.pool = list(pool.cpu().numpy())
        del pool
        self.task = build_task(self.cfg, self.seed, self.device)
        self.sample = random.Random(sub_seed(self.seed, 4))
        for _ in range(self.p["warmup_requests"]):
            self._request()

    def _request(self):
        i = self.next
        self.next += 1
        out = self.run_inference(self.task, {"x": self.pool[i % len(self.pool)]},
                                 seed=self.request_seed(self.seed, i))
        return i, out

    def window(self, seconds: float) -> dict:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        keep_p = self.p["kept_share"]
        lat = []
        images = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            ta = time.perf_counter()
            i, out = self._request()
            tb = time.perf_counter()
            lat.append(tb - ta)
            images += len(out)
            if self.sample.random() < keep_p or not self.kept:
                self.kept[i] = out
            if tb >= deadline:
                break
        elapsed = time.perf_counter() - t0
        p95 = (statistics.quantiles(lat, n=20, method="inclusive")[18]
               if len(lat) > 1 else lat[0])
        self.log(f"window: {len(lat)} requests, {images} images in "
                 f"{elapsed:.4f} s; latency median "
                 f"{1000 * statistics.median(lat):.4f} ms, p95 "
                 f"{1000 * p95:.4f} ms over {len(lat)} samples; "
                 f"{len(self.kept)} answers kept")
        return {"attempted": len(lat), "failed": 0,
                "images_per_s": images / elapsed,
                "s_per_unit": elapsed / len(lat),
                "metrics": {"serve_images_per_s": images / elapsed,
                            "serve_latency_ms_p95": 1000.0 * p95},
                "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if cuda else 0)}

    def trace(self):
        """Two spans of ``trace_requests`` requests: the device activity
        alone, then with the host operators and their shapes; (span, op
        span, None: no synchronising calls are counted)."""
        k = self.p["trace_requests"]

        def run(control):
            control.open()
            for _ in range(k):
                self._request()
            control.close()
            return k

        return (trace.profile_span(run, self.scratch, self.log),
                trace.profile_span(run, self.scratch, self.log, with_ops=True),
                None)

    def release(self) -> None:
        del self.task
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: Precision = F32) -> Dict[int, torch.Tensor]:
        """The reference's answer (NHWC f32, clipped) to each kept
        request."""
        cuda = self.device.type == "cuda"
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        try:
            fam = family(self.cfg, prec, self.device)
            fam.load(weights.make(self.cfg, sub_seed(self.seed, 0),
                                  self.device))
            out = {}
            for i in sorted(self.kept):
                x = torch.from_numpy(self.pool[i % len(self.pool)]).to(
                    self.device).permute(0, 3, 1, 2)
                gen = torch.Generator(self.device).manual_seed(
                    self.request_seed(self.seed, i))
                out[i] = fam.generate(x, gen).clamp(0.0, 1.0).permute(
                    0, 2, 3, 1)
            return out
        finally:
            if cuda:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = saved

    def numbers(self, answers: Dict[int, torch.Tensor]) -> Dict[str, float]:
        """``image_rms`` of the kept answers against `answers`: per
        request, the RMS of the images' difference over the RMS of the
        reference's; the worst request."""
        worst = 0.0 if self.kept else math.inf
        for i, ref in answers.items():
            got = torch.as_tensor(self.kept[i], device=ref.device)
            if got.shape != ref.shape or not torch.isfinite(got).all():
                return {"image_rms": math.inf}
            gap = (torch.linalg.vector_norm(got - ref)
                   / torch.linalg.vector_norm(ref).clamp_min(1e-30))
            worst = max(worst, float(gap))
        return {"image_rms": worst}

    def per_image(self, answers: Dict[int, torch.Tensor]):
        """Per kept request, each image's relative RMS gap (diagnostics)."""
        out = {}
        for i, ref in answers.items():
            got = torch.as_tensor(self.kept[i], device=ref.device)
            d = (got - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(
                dim=1).clamp_min(1e-30)
            out[i] = [round(v, 5) for v in d.tolist()]
        return out

    def compare(self, wanted) -> Dict[str, float]:
        return self.numbers(self.reference())
