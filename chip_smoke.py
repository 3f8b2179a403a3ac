#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vae_cyclegan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (Hopper: the
kernels are built for sm_90a) and nvcc. Phases, one line per finding:

  1. card:    the card's name and power limit (nvidia-smi); fails without CUDA
  2. build:   compiles csrc/*.cu into build/kernels/ (ptxas report in
              chiprun_out/build.log)
  3. kernels: each hand-written kernel against its plain PyTorch version on
              the card, at the serving path's shapes and at edge shapes
  4. slice:   the cyclevaegan generator at full width (256x256, base 64,
              latent 64, bf16, seeded random weights) serves requests at
              batch 1, 4 and 16 through run_inference; every generator
              forward must launch the IN+act kernel 5 times and the conv
              kernel 2 times; the f32 and the bf16 forward on the card must
              agree with the port's plain CPU forward in the same dtype, on
              the same weights and noise
  5. times:   kernel vs plain (CUDA events), request latency per batch size
              (host clock, median), peak device memory, a profiler summary

Any failed check raises, and the script exits non-zero without printing its
last line, ``{"ok": true, "device": {...}}``. The line before it is the
``{"kernels": [...]}`` summary.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.inference import run_inference
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.ops.instance_norm import (
    ORDERS,
    fused_reference,
    in_act_cuda,
)
from vae_cyclegan_tpu_torch.ops.reflect_conv import reflect_conv
from vae_cyclegan_tpu_torch.ops.starved_conv import reflect_conv_cuda

OUT_DIR = Path("chiprun_out")
IMAGE, BASE, LATENT = 256, 64, 64
BATCHES = (1, 4, 16)
PATH_BATCH = 4
ACTS = ("relu", "leaky_relu", "tanh", "sigmoid", "identity")
# allclose-style bounds |kernel - plain| <= atol + rtol * |plain|, per dtype:
# f32 differs only in summation order; bf16 also in where the f32 result is
# rounded (1 bf16 ulp is 2^-7 relative at most).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# the f32 slice on the card against the port's CPU forward: the band of the
# JAX package's reference-parity test (tests/test_reference_parity.py)
SLICE_TOL = (1e-3, 1e-2)
# the bf16 slice on the card against the port's bf16 CPU forward.
# Block by block, on the same input: every element within one bf16 rounding
# at the block output's largest magnitude. The share of elements that differ
# at all is printed, not bounded: where a block chains two convs, a rounding
# that flips in the first (the libraries sum in other orders) nudges many
# sums of the second across a rounding boundary (7.4e-2 of the encoder R
# block's elements between cuDNN + the kernels and the CPU). Where the
# roundings sit is held to the JAX package's on the CPU
# (tests/test_torch_networks.py), and the kernels to their plain versions.
# Whole: a one-rounding difference grows through the 18 convs and 11 norms,
# so the relative L2 error is held to the distance of the card's bf16 output
# from its f32 output. Two bf16 runs that round at the same places stay
# closer to each other than to f32 (ratio < 1); runs whose rounding errors
# were independent would drift up to about sqrt(2) times that distance.
BF16_SLICE_SHARE_OF_F32_GAP = 1.0
# tests/test_starved_conv.py CONV_CASES, (h, w, cin, cout, k)
CONV_CASES = [(32, 40, 3, 16, 7), (32, 40, 16, 3, 7), (32, 32, 8, 16, 3),
              (32, 32, 16, 8, 3), (48, 40, 3, 8, 5), (40, 48, 4, 8, 3)]
DEV = torch.device("cuda")


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def randn(shape, seed: int, dtype=torch.float32, scale: float = 1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(DEV, dtype)


def compare(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    atol, rtol = TOL[want.dtype]
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{label}: {tuple(got.shape)}/{got.dtype} vs "
            f"{tuple(want.shape)}/{want.dtype}")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    max_err = float(err.max())
    torch.cuda.synchronize()
    say(f"check {label}: max_abs_err={max_err:.3e} "
        f"(atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    require(ok, label)
    return max_err


def cuda_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Summed duration of the GPU kernels `fn` launches, per call (from
    the profiler: what the device spends, without the host's launch gaps)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    require(us > 0, "the profiler saw device time")
    return us / 1e3 / iters


def kernel_vs_plain(kernel_fn, plain_fn, iters: int) -> dict:
    """Per call, warmed up: the CUDA-event time of a loop of `iters` calls
    (host launch cost included where the host is the slower side), timed
    in the order plain, kernel, kernel, plain; then the device time."""
    for fn in (plain_fn, kernel_fn):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "device_ms": device_ms(kernel_fn, iters),
            "plain_device_ms": device_ms(plain_fn, iters)}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); the port's smoke run needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # f32 references must be true f32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.load()
    say(f"build: {kernels.library_path().name} ready in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {kernels.build_seconds})")
    if kernels.build_log:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "build.log").write_text(kernels.build_log)
        for line in kernels.build_log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas: {line.strip()}")


def phase_kernels() -> dict:
    errs = {"in_act": 0.0, "starved_conv": 0.0}
    b16, f32 = torch.bfloat16, torch.float32
    cases = []  # (shape, dtype, act, order)
    for b in (PATH_BATCH, 16):
        for dtype in (b16, f32):
            for act in ("relu", "identity"):
                cases.append(((b, 16 * BASE, IMAGE // 16, IMAGE // 16), dtype,
                              act, "act_norm"))
    for dtype in (b16, f32):
        for act in ACTS:
            for order in ORDERS:
                cases.append(((2, 8, 16, 16), dtype, act, order))
        cases.append(((2, 3, 7, 9), dtype, "leaky_relu", "norm_act"))
        cases.append(((1, 4, 128, 128), dtype, "relu", "act_norm"))  # 3-pass
        # the largest plane held in shared memory, and the smallest past it
        cases.append(((1, 2, 8, 1535), dtype, "tanh", "norm_act"))
        cases.append(((1, 3, 96, 128), dtype, "relu", "act_norm"))
    for i, (shape, dtype, act, order) in enumerate(cases):
        x = randn(shape, seed=i, dtype=dtype, scale=2.0) + 0.5
        got = in_act_cuda(x, act, order)
        want = fused_reference(x, act, order)
        err = compare(f"in_act {shape} {str(dtype)[6:]} {act}/{order}",
                      got, want)
        errs["in_act"] = max(errs["in_act"], err)

    convs = [((PATH_BATCH, BASE // 2, IMAGE, IMAGE), (BASE, BASE // 2, 3)),
             ((PATH_BATCH, BASE, IMAGE, IMAGE), (3, BASE, 7))]
    convs += [((2, cin, h, w), (cout, cin, k))
              for h, w, cin, cout, k in CONV_CASES]
    for i, (xs, (cout, cin, k)) in enumerate(convs):
        for dtype in (b16, f32):
            x = randn(xs, seed=100 + i, dtype=dtype)
            w = randn((cout, cin, k, k), seed=200 + i, dtype=dtype,
                      scale=(2.0 / (cout * k * k)) ** 0.5)
            got = reflect_conv_cuda(x, w)
            want = reflect_conv(x, w)
            err = compare(f"starved_conv x{xs} w{(cout, cin, k, k)} "
                          f"{str(dtype)[6:]}", got, want)
            errs["starved_conv"] = max(errs["starved_conv"], err)
    return errs


def _task(dtype, device):
    task = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT, BASE,
                                                        dtype), device=device)
    task.init(0)
    return task


def check_bf16_blocks(gpu_net, cpu_net, x, eps) -> None:
    """Each block of the bf16 generator on the card against the same block
    on the CPU, both fed the CPU forward's input to that block (f32 image,
    NHWC eps). Band: one bf16 rounding at the output's largest magnitude,
    |err| <= 2^-7 (|want| + max|want|)."""
    h = torch.as_tensor(x).permute(0, 3, 1, 2).contiguous()
    eps = torch.as_tensor(eps).permute(0, 3, 1, 2)
    stages = [(f"encoder.model.{i}", gpu_net.encoder.model[i],
               cpu_net.encoder.model[i]) for i in range(6)]
    stages.append(("variational_encoder_block",
                   gpu_net.variational_encoder_block,
                   cpu_net.variational_encoder_block))
    stages.append(("variational_decoder_block",
                   gpu_net.variational_decoder_block,
                   cpu_net.variational_decoder_block))
    stages += [(f"decoder.model.{i}", gpu_net.decoder.model[i],
                cpu_net.decoder.model[i]) for i in range(6)]
    with torch.no_grad():
        for name, gpu_mod, cpu_mod in stages:
            if name == "variational_encoder_block":
                wants = cpu_mod(h, eps=eps)
                gots = gpu_mod(h.to(DEV), eps=eps)
                labels = ("z", "mu", "logvar")
            else:
                wants, gots, labels = (cpu_mod(h),), (gpu_mod(h.to(DEV)),), ("",)
            for label, got, want in zip(labels, gots, wants):
                require(got.dtype == want.dtype == torch.bfloat16,
                        f"{name} {label} dtype {got.dtype}/{want.dtype}")
                g, w = got.float().cpu(), want.float()
                err = (g - w).abs()
                band = 2.0 ** -7 * (w.abs() + w.abs().max())
                worst = float((err / band).max())
                share = float((g != w).float().mean())
                ok = bool(torch.isfinite(g).all()) and worst <= 1.0
                say(f"check bf16 block {name} {label}: max_abs_err "
                    f"{float(err.max()):.3e}, {worst:.3f} of the band; "
                    f"{share:.2e} of elements differ "
                    f"{'ok' if ok else 'FAIL'}")
                require(ok, f"bf16 block {name} {label}")
            h = wants[0]


def phase_slice() -> dict:
    task = _task(torch.bfloat16, DEV)
    rng = np.random.RandomState(0)
    requests = [rng.rand(b, IMAGE, IMAGE, 3).astype(np.float32)
                for b in BATCHES]
    torch.cuda.synchronize()

    # the main path: the counts cover exactly these requests
    in_act_cuda.launches = 0
    reflect_conv_cuda.launches = 0
    outs = []
    for seed, x in enumerate(requests):
        before = (in_act_cuda.launches, reflect_conv_cuda.launches)
        outs.append(run_inference(task, {"x": x}, seed=seed))
        per = (in_act_cuda.launches - before[0],
               reflect_conv_cuda.launches - before[1])
        require(per == (5, 2), f"batch {x.shape[0]}: {per} launches of "
                               "(in_act, starved_conv), expected (5, 2)")
    launches = {"in_act": in_act_cuda.launches,
                "starved_conv": reflect_conv_cuda.launches}
    say(f"slice: {len(requests)} requests (batch {BATCHES}), launches "
        f"{launches}: 5 in_act + 2 starved_conv per generator forward ok")
    for x, out in zip(requests, outs):
        require(out.shape == x.shape and out.dtype == np.float32,
                f"output {out.shape} {out.dtype}")
        require(bool(np.isfinite(out).all()) and out.min() >= 0.0
                and out.max() <= 1.0, "output finite and in [0, 1]")
        say(f"slice: batch {x.shape[0]} -> {out.shape} float32, finite, "
            f"mean {out.mean():.4f}")

    # f32 on the card (kernels) against the port's plain CPU forward
    x = requests[0]
    eps = np.random.RandomState(1).randn(
        1, IMAGE // 16, IMAGE // 16, LATENT).astype(np.float32)
    gpu32 = _task(torch.float32, DEV).generate({"x": x}, eps=eps)
    cpu32 = _task(torch.float32, "cpu").generate({"x": x}, eps=eps)
    got, want = gpu32.float().cpu(), cpu32.float()
    atol, rtol = SLICE_TOL
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, atol=atol, rtol=rtol)
    say(f"check slice f32 card vs CPU (batch 1, TF32 off): max_abs_err="
        f"{err:.3e} (atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    require(ok, "slice f32 card vs CPU")

    # bf16 on the card against the port's bf16 CPU forward, same weights
    # and eps: block by block, then whole
    cpu_task = _task(torch.bfloat16, "cpu")
    check_bf16_blocks(task.G, cpu_task.G, x, eps)
    b16 = task.generate({"x": x}, eps=eps).float().cpu()
    cpu16 = cpu_task.generate({"x": x}, eps=eps).float()
    require(bool(torch.isfinite(b16).all()), "bf16 slice finite")
    gap = float((b16 - got).norm() / got.norm())
    rel = float((b16 - cpu16).norm() / cpu16.norm())
    bound = BF16_SLICE_SHARE_OF_F32_GAP * gap
    ok = rel <= bound
    say(f"check slice bf16 card vs bf16 CPU (batch 1): relative L2 error "
        f"{rel:.3e}, max_abs_err {float((b16 - cpu16).abs().max()):.3e} "
        f"(bound {bound:.3e}: {BF16_SLICE_SHARE_OF_F32_GAP:g} x the "
        f"bf16-vs-f32 distance on the card, {gap:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, "slice bf16 card vs bf16 CPU")
    return {"task": task, "launches": launches}


def phase_times(card: str, sl: dict) -> dict:
    b16 = torch.bfloat16
    times = {}

    def show(label, t):
        say(f"time {label} bf16: kernel {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms (device "
            f"{t['plain_device_ms']:.4f}) [{card}]")

    # kernels at the path shapes (batch 4 and 16, bf16)
    for b in (PATH_BATCH, 16):
        x = randn((b, 16 * BASE, IMAGE // 16, IMAGE // 16), 7, b16)
        t = kernel_vs_plain(lambda: in_act_cuda(x, "relu", "act_norm"),
                            lambda: fused_reference(x, "relu", "act_norm"),
                            200)
        times[("in_act", b)] = t
        show(f"in_act {tuple(x.shape)}", t)
        total = dict.fromkeys(t, 0.0)
        for name, cin, cout, kk in (("U4", BASE // 2, BASE, 3),
                                    ("tail", BASE, 3, 7)):
            x = randn((b, cin, IMAGE, IMAGE), 8, b16)
            w = randn((cout, cin, kk, kk), 9, b16, 0.05)
            t = kernel_vs_plain(lambda: reflect_conv_cuda(x, w),
                                lambda: reflect_conv(x, w), 20)
            show(f"starved_conv {name} x{tuple(x.shape)} w{tuple(w.shape)}", t)
            total = {key: total[key] + t[key] for key in t}
        times[("starved_conv", b)] = total

    # request latency per batch size, peak memory, and the device's busy
    # time per request (profiler) against that latency. The task holds F's
    # f32 weights on the card too, which generate never reads.
    task = sl["task"]
    f_mib = sum(p.numel() * p.element_size()
                for p in task.F.parameters()) / 2 ** 20
    for b in BATCHES:
        x = torch.as_tensor(np.random.RandomState(b).rand(
            b, IMAGE, IMAGE, 3).astype(np.float32), device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(b)
        for _ in range(3):
            task.generate({"x": x}, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        for _ in range(25):
            t0 = time.perf_counter()
            task.generate({"x": x}, generator=gen)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(lat))
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        busy = device_ms(lambda: task.generate({"x": x}, generator=gen), 5)
        times[("slice", b)] = med
        say(f"time slice generate batch {b} bf16: median {med:.3f} ms of "
            f"{len(lat)} (min {min(lat):.3f}, max {max(lat):.3f}), "
            f"{b / med * 1e3:.1f} img/s, device busy {busy:.3f} ms per "
            f"request (idle share {max(0.0, 1 - busy / med):.2f}), peak "
            f"memory {peak:.0f} MiB, {peak - f_mib:.0f} MiB without F's "
            f"unread weights ({f_mib:.1f} MiB) [{card}]")

    # where the device time of batch-4 requests goes, by kernel
    x = torch.as_tensor(np.random.RandomState(0).rand(
        PATH_BATCH, IMAGE, IMAGE, 3).astype(np.float32), device=DEV)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            task.generate({"x": x})
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=30)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "profile_batch4.txt").write_text(table)
    say("profile (batch 4, 5 requests; top self device time, full table in "
        "chiprun_out/profile_batch4.txt):")
    for line in table.splitlines()[:16]:
        say(f"  {line}")
    return times


def main() -> None:
    card = phase_card()
    phase_build()
    errs = phase_kernels()
    sl = phase_slice()
    times = phase_times(card, sl)
    summary = {"kernels": [
        {"name": "in_act", "route": "cuda",
         "source": "vae_cyclegan_tpu_torch/csrc/in_act.cu",
         "replaces": "vae_cyclegan_tpu/ops/instance_norm.py:110",
         "launches": sl["launches"]["in_act"],
         "max_abs_err": errs["in_act"],
         **times[("in_act", PATH_BATCH)]},
        {"name": "starved_conv", "route": "cuda",
         "source": "vae_cyclegan_tpu_torch/csrc/starved_conv.cu",
         "replaces": "vae_cyclegan_tpu/ops/starved_conv.py:279",
         "launches": sl["launches"]["starved_conv"],
         "max_abs_err": errs["starved_conv"],
         # U4 + tail: one generator forward's two sites at batch 4
         **times[("starved_conv", PATH_BATCH)]},
    ]}
    print(json.dumps(summary), flush=True)
    print(f"card (name, power.limit): {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # report and exit non-zero without the result
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
