"""Benchmark of the port: ONE JSON line on stdout.

    python -m vae_cyclegan_tpu_torch.bench

Counterpart of the root ``bench.py``: 256x256 train images/sec on the
flagship VAE-CycleGAN (cyclevaegan), unpaired, the full G+D alternating
train step, at batch 24, bf16, on one CUDA card.

Baseline: the reference publishes no numbers; its PyTorch-CPU training
step was measured in-situ (BASELINE.md): cyclevaegan at 256x256 = 0.0459
images/sec. vs_baseline = ours / that.

Environment, as ``bench.py`` reads it: BENCH_ARCH (cyclevaegan),
BENCH_BATCH (24), BENCH_STEPS (10), BENCH_PRECISION (bf16 | float32),
BENCH_IMAGE_SIZE (256), BENCH_PHASE (all | e2e | loader), BENCH_E2E_MODE
(host | device), BENCH_E2E_STEPS (12), BENCH_LOADER_STEPS (24),
BENCH_LOADER_WORKERS (1,4), BENCH_TRACE, BENCH_E2E and BENCH_LOADER_ONLY
(1; 0 skips that part), BENCH_REMAT (1 rematerializes the generator
passes, ``ModelConfig.remat``), BENCH_UNIFIED (1, the default, as in
``bench.py``: the step runs through a world-1 process group, NCCL on the
card and gloo on the CPU, the same code an N-rank data-parallel run takes:
the gradient mean's one all_reduce per optimizer and the metrics' mean; 0
runs the plain step without a group; the line's ``unified`` says which).
BENCH_DEVICE (cuda) names the torch device; the tests set it to cpu.
``bench.py``'s BENCH_SPATIAL has no counterpart in the port yet (ROADMAP.md
queue 1, item 7c), and BENCH_NO_PALLAS has none by design (item 10: no
switch turns the kernels off, and no caller of the port needs a plain-only
mode): if one is set, the bench fails.

Phases: the step (3 warm-up steps, then the median of 3 windows of
BENCH_STEPS steps, each window closed by reading G_loss; per-step times
from CUDA events around each step; the kernels' summed device time per step
from ``torch.profiler``); e2e (epochs of ``Engine.train_epoch``: decoded-
image cache -> prefetching loader -> ``Engine._put`` -> step, with the
engine's per-batch phase breakdown) and the loader alone with host-to-
device bandwidth, each in a fresh child process, on a tree of
BENCH_E2E_STEPS batches. On any error it prints the ``bench_error`` line
and exits 1.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from vae_cyclegan_tpu_torch.parallel import mesh

REFERENCE_CPU_IMAGES_PER_SEC = 0.04589  # cyclevaegan, measured (BASELINE.md)
ROOT = Path(__file__).resolve().parents[1]
#: bench.py's switches that the port does not have
UNPORTED = ("BENCH_SPATIAL", "BENCH_NO_PALLAS")
#: kernel launches of one unpaired cyclevaegan train_step at 256x256, base
#: 64, bf16, "auto" IN (tests/test_torch_bench.py holds them to the step's
#: kernel sites): K1, K3 reflect, K3 zero_same, K4
UNPAIRED_STEP_LAUNCHES = {"in_act": 46, "starved_conv": 12,
                          "starved_conv_zero_same": 10, "starved_conv_dw": 12}


def _reference_images_per_sec(arch: str) -> float:
    """Per-config reference-CPU baseline (BASELINE.md tables). The flagship
    number is pinned; the other config families come from the in-situ
    measurements in docs/reference_baseline.json."""
    if arch == "cyclevaegan":
        return REFERENCE_CPU_IMAGES_PER_SEC
    if arch == "autoencoder":
        return 0.316  # round-1 in-situ measurement (BASELINE.md)
    try:
        rows = json.loads((ROOT / "docs" / "reference_baseline.json")
                          .read_text())
        for row in rows:
            if row["architecture"] == arch:
                return float(row["images_per_sec"])
    except (OSError, ValueError, KeyError):
        pass
    return REFERENCE_CPU_IMAGES_PER_SEC


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _device() -> torch.device:
    """BENCH_DEVICE, the card by default; a card that is not there is an
    error, never a fallback to the CPU."""
    for name in UNPORTED:
        if name in os.environ:
            raise RuntimeError(
                f"{name} is not ported (the port's bench has no counterpart "
                f"of {', '.join(UNPORTED)}); unset it")
    dev = torch.device(os.environ.get("BENCH_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (BENCH_DEVICE=cpu runs on the CPU)")
    return dev


def _card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return str(dev)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _run_phase_subprocess(phase: str, timeout: float = 1200.0) -> dict:
    """Run one auxiliary bench phase (e2e / loader) in a FRESH process and
    return its parsed JSON dict, so host-side phases do not inherit the step
    phase's leftover host work (allocator state, profiler buffers)."""
    env = dict(os.environ)
    env["BENCH_PHASE"] = phase
    out = subprocess.run(
        [sys.executable, "-m", "vae_cyclegan_tpu_torch.bench"],
        capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
        env=env,
    )
    for line in reversed(out.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            parsed = json.loads(line)
            if parsed.get("metric") == "bench_error":
                raise RuntimeError(
                    f"phase {phase} failed: {parsed.get('error', '?')}")
            return parsed
    raise RuntimeError(
        f"phase {phase} subprocess produced no JSON "
        f"(rc={out.returncode}): {(out.stderr or out.stdout)[-300:]}")


def _launch_counters() -> dict:
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from vae_cyclegan_tpu_torch.ops.instance_norm import in_act_cuda
    from vae_cyclegan_tpu_torch.ops.starved_conv import (
        dw_cuda,
        reflect_conv_cuda,
        zero_conv_cuda,
    )

    return {"in_act": in_act_cuda, "starved_conv": reflect_conv_cuda,
            "starved_conv_zero_same": zero_conv_cuda,
            "starved_conv_dw": dw_cuda}


def _one_step_counts(task, step_fn) -> tuple:
    """(kernel launches, host reads of the loss) of one step: the launch
    counts set to 0 just before it, and the task's finite-loss gate (one
    host read of the loss per optimizer) counted."""
    counters = _launch_counters()
    reads = []
    gate = task._finite_update

    def counted(*args, **kwargs):
        reads.append(1)
        return gate(*args, **kwargs)

    for fn in counters.values():
        fn.launches = 0
    task._finite_update = counted
    try:
        step_fn()
    finally:
        del task._finite_update
    return {n: fn.launches for n, fn in counters.items()}, len(reads)


def main() -> None:
    dev = _device()
    from vae_cyclegan_tpu_torch.config import ModelConfig
    from vae_cyclegan_tpu_torch.engine import Engine
    from vae_cyclegan_tpu_torch.models.tasks import create_task

    arch = os.environ.get("BENCH_ARCH", "cyclevaegan")
    batch = _env_int("BENCH_BATCH", 24)
    steps = _env_int("BENCH_STEPS", 10)
    precision = os.environ.get("BENCH_PRECISION", "bf16")
    image_size = _env_int("BENCH_IMAGE_SIZE", 256)
    # phase routing: "all" (default) measures the step in-process and
    # delegates the host-sensitive phases to fresh subprocesses; "e2e" /
    # "loader" are those children.
    phase = os.environ.get("BENCH_PHASE", "all")
    if phase == "loader":
        out = {"loader_only_images_per_sec": {
            str(w): round(r, 1)
            for w, r in _bench_loader_only(batch, image_size).items()
        }}
        out.update(_bench_h2d(dev))
        print(json.dumps(out))
        return

    mc = ModelConfig(image_size=image_size, latent_dim=64, base_width=64,
                     dtype=torch.bfloat16 if precision == "bf16"
                     else torch.float32,
                     remat=os.environ.get("BENCH_REMAT", "0") == "1")
    # the BASELINE config #5: unpaired summer2winter-style full dual cycle
    task = create_task(arch, model=mc, paired=False, device=dev)
    task.init(0)
    unified = None
    if os.environ.get("BENCH_UNIFIED", "1") != "0":
        mesh.make_group(1, dev, 0, f"tcp://127.0.0.1:{mesh.free_port()}")
        unified = {"backend": dist.get_backend(), "world_size": 1}
    engine = Engine(task, seed=0,
                    group=None if unified is None else dist.group.WORLD)

    if phase == "e2e":
        e2e = _bench_e2e(engine, batch, image_size)
        print(json.dumps({
            "e2e_loader_images_per_sec": e2e.pop("images_per_sec"),
            "e2e_batches_per_epoch": e2e.pop("batches_per_epoch"),
            "e2e_breakdown": e2e}))
        mesh.destroy()
        return

    gen = torch.Generator(dev).manual_seed(0)
    shape = (batch, image_size, image_size, 3)
    batch_data = {"x": torch.rand(shape, generator=gen, device=dev),
                  "y": torch.rand(shape, generator=gen, device=dev)}

    def step():
        return engine.train_step(batch_data)

    # warm-up (kernel build on first use + 2 steady steps); a scalar read
    # closes it
    for _ in range(3):
        metrics = step()
    float(metrics["G_loss"])
    launches, syncs = _one_step_counts(task, step)

    # throughput as the epoch loop runs: a window of steps, one read of the
    # loss at its end; the median of 3 windows
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = step()
        float(metrics["G_loss"])
        rates.append(batch * steps / (time.perf_counter() - t0))
    images_per_sec = sorted(rates)[1]

    step_kind = ("G+D step" if arch in
                 ("aegan", "vaegan", "cycleaegan", "cyclevaegan")
                 else "train step")
    result = {
        "metric": f"{arch} {image_size}x{image_size} train images/sec/chip "
                  f"({step_kind}, batch {batch}, {precision}, unpaired)",
        "value": round(images_per_sec, 3),
        "unit": "images/sec",
        "vs_baseline": round(
            images_per_sec / _reference_images_per_sec(arch), 1),
        # window-amortized mean step time (1000 * batch / median window
        # rate); the per-step distribution comes from the events below
        "step_time_ms_window_mean": round(1000.0 * batch / images_per_sec, 2),
        "device": _card(dev),
        "syncs_per_step": syncs,
        "launches_per_step": launches,
        "remat": mc.remat,
        "unified": unified,
    }
    if os.environ.get("BENCH_TRACE", "1") != "0":
        try:
            result.update(_bench_step_distribution(step, steps, dev,
                                                   result))
        except Exception as e:  # noqa: BLE001 — the trace is auxiliary
            result["step_trace_error"] = f"{type(e).__name__}: {e}"
    if os.environ.get("BENCH_E2E", "1") != "0":
        # the e2e configuration, in a fresh process
        try:
            result.update(_run_phase_subprocess("e2e"))
            mode = os.environ.get("BENCH_E2E_MODE", "host")
            result["e2e_config"] = {
                "mode": mode,
                "wire": "uint8 full frames (on-device aug)"
                if mode == "device" else "uint8 crops",
                "decode_cache": True, "clean_process": True,
            }
        except Exception as e:  # noqa: BLE001 — e2e is auxiliary
            result["e2e_error"] = f"{type(e).__name__}: {e}"
    if os.environ.get("BENCH_LOADER_ONLY", "1") != "0":
        # host capability with no device in the loop, in a fresh process
        try:
            result.update(_run_phase_subprocess("loader"))
        except Exception as e:  # noqa: BLE001
            result["loader_only_error"] = f"{type(e).__name__}: {e}"
    mesh.destroy()
    print(json.dumps(result))


def _percentile(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))]


def _bench_step_distribution(step, steps: int, dev: torch.device,
                             result: dict) -> dict:
    """Per-step time percentiles over `steps` steps (at least 5): on the
    card, CUDA events recorded around each step on the compute stream (the
    step's span on the device, its idle gaps included); on the CPU, the
    host clock. On the card also the kernels' summed device time per step
    over two profiled steps, and the share of the window-mean step the
    device sat idle."""
    steps = max(int(os.environ.get("BENCH_TRACE_STEPS", steps)), 5)
    times = []
    if dev.type == "cuda":
        pairs = []
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(dev)
        times = [s.elapsed_time(e) for s, e in pairs]
        source = "cuda events"
    else:
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            times.append(1000 * (time.perf_counter() - t0))
        source = "host clock (cpu)"
    out = {"step_time_ms_p50": round(statistics.median(times), 2),
           "step_time_ms_p95": round(_percentile(times, 0.95), 2),
           "step_time_samples": len(times), "step_time_source": source}
    if dev.type == "cuda":
        busy = _kernel_ms_per_step(step, dev, 2)
        if busy is None:
            out["kernel_ms_per_step"] = "not measured"
        else:
            out["kernel_ms_per_step"] = round(busy, 2)
            out["device_idle_share"] = round(
                1 - busy / result["step_time_ms_window_mean"], 4)
    return out


def _kernel_ms_per_step(step, dev: torch.device, n: int, tries: int = 3):
    """Summed device time of the kernels of `n` steps under torch.profiler,
    per step. A session that recorded no device activity (the profiler now
    and then keeps none) is run again, up to `tries` times; None after."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize(dev)
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1000.0 / n
    return None


def _tree_frames(batch: int) -> int:
    """Frames of the e2e and loader-only tree: an epoch of BENCH_E2E_STEPS
    batches (bench.py's tree holds one batch, so its loader restarts, cold,
    on every batch)."""
    return batch * max(2, _env_int("BENCH_E2E_STEPS", 12))


def _synthetic_hypersim_tree(td, n_frames: int) -> None:
    """Full-res synthetic Hypersim frame tree of at least `n_frames`
    frames (shared by the e2e and loader-only benches), written as PNGs
    with Pillow, as bench.py writes it (at its fastest compression: the
    timed windows read the decoded-image cache)."""
    import numpy as np
    from PIL import Image

    xx, yy = np.meshgrid(np.linspace(0, 1, 1024), np.linspace(0, 1, 768))
    base = np.stack([xx, yy, 0.5 * (xx + yy)], -1)
    n_frames = max(2, n_frames)
    for cam in ("cam_00", "cam_01"):
        root = Path(td) / "hypersim" / "ai_001_001_indoor" / cam
        root.mkdir(parents=True)
        for frame in range(-(-n_frames // 2)):
            img = np.roll(base, 37 * frame + (cam == "cam_01"), axis=1)
            arr = (img * 255).astype(np.uint8)
            for mod in ("depth", "normal"):
                Image.fromarray(arr).save(
                    root / f"frame_{frame:04d}_{mod}.png", compress_level=1)


def _bench_loader_only(batch: int, image_size: int) -> dict:
    """Pure host pipeline rate (cache -> loader -> host crop/resize/uint8
    wire), device untouched: {num_workers: images/sec}, plus raw mode at
    one worker ("1_raw": full frames, no host crop/resize). The e2e tree:
    an epoch of several batches, epochs run back to back."""
    import tempfile

    from vae_cyclegan_tpu_torch.data import (
        AugmentConfig,
        DataLoader,
        DecodedImageCache,
        HypersimDataset,
    )
    from vae_cyclegan_tpu_torch.data import datasets as _ds_mod

    steps = _env_int("BENCH_LOADER_STEPS", 24)
    workers = [int(w) for w in
               os.environ.get("BENCH_LOADER_WORKERS", "1,4").split(",")]
    rates = {}
    with tempfile.TemporaryDirectory() as td:
        _synthetic_hypersim_tree(td, _tree_frames(batch))
        DecodedImageCache(DecodedImageCache.build(
            Path(td) / "hypersim", Path(td) / "img.cache")).attach()
        try:
            for w, raw in [(w, False) for w in workers] + [(1, True)]:
                ds = HypersimDataset(
                    str(Path(td) / "hypersim"), ["depth", "normal"],
                    augment=AugmentConfig(out_size=image_size,
                                          hflip_p=0.5, vflip_p=0.3),
                    paired_mode=False, raw_mode=raw, uint8_output=True,
                )
                loader = DataLoader(ds, batch, shuffle=True, num_workers=w,
                                    drop_last=True, prefetch=3)
                try:
                    n = 0
                    for _ in loader:  # warm worker pool + prefetch depth
                        n += 1
                        if n >= 2:
                            break
                    n = 0
                    t0 = time.perf_counter()
                    while n < steps:
                        saw = False
                        for _ in loader:
                            saw = True
                            n += 1
                            if n >= steps:
                                break
                        if not saw:
                            raise RuntimeError("loader yielded no batches")
                    rates["1_raw" if raw else w] = (
                        batch * steps / (time.perf_counter() - t0))
                finally:
                    loader.close()
        finally:
            _ds_mod.set_decode_cache(None)
    return rates


def _bench_h2d(dev: torch.device) -> dict:
    """Host -> device copy bandwidth in MB/s of a 64 MB uint8 buffer, best
    of 3, from pinned and from pageable host memory; null off the card."""
    if dev.type != "cuda":
        return {"h2d_bandwidth_mb_s": None, "h2d_pinned_mb_s": None,
                "h2d_pageable_mb_s": None}
    pageable = torch.randint(0, 255, (64 << 20,), dtype=torch.uint8)
    pinned = pageable.pin_memory()
    out = {}
    for name, buf in (("pinned", pinned), ("pageable", pageable)):
        buf[: 1 << 20].to(dev)  # warm path
        torch.cuda.synchronize(dev)
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            buf.to(dev, non_blocking=True)
            torch.cuda.synchronize(dev)
            best = max(best, buf.numel() / (time.perf_counter() - t0) / 1e6)
        out[f"h2d_{name}_mb_s"] = round(best, 1)
    out["h2d_bandwidth_mb_s"] = out["h2d_pinned_mb_s"]
    return out


def _bench_e2e(engine, batch: int, image_size: int) -> dict:
    """End-to-end rate with the REAL data path, through the loop users
    train with: ``Engine.train_epoch`` over decoded-image cache ->
    prefetching loader -> ``Engine._put`` -> the step (on-device
    augmentation inside it in device mode). A synthetic Hypersim-format
    tree of full-res frames (``_tree_frames``: an epoch of BENCH_E2E_STEPS
    batches), so the loader does the production work minus PNG decode
    (removed by the cache) and its prefetch spans the steps of an epoch.

    One epoch warms the kernels, then 3 epochs are timed. Returns
    {'images_per_sec': the median epoch's ``train_epoch`` rate, plus that
    epoch's ``Engine.epoch_phases`` (ms)}."""
    import tempfile

    from vae_cyclegan_tpu_torch.data import (
        AugmentConfig,
        DataLoader,
        DecodedImageCache,
        HypersimDataset,
    )
    from vae_cyclegan_tpu_torch.data import datasets as _ds_mod

    with tempfile.TemporaryDirectory() as td:
        _synthetic_hypersim_tree(td, _tree_frames(batch))
        DecodedImageCache(DecodedImageCache.build(
            Path(td) / "hypersim", Path(td) / "img.cache")).attach()
        loader = None
        try:
            # 'host' crops + resizes on the host and ships out_size^2 uint8;
            # 'device' ships full raw frames and augments on the card
            raw = os.environ.get("BENCH_E2E_MODE", "host") == "device"
            ds = HypersimDataset(
                str(Path(td) / "hypersim"), ["depth", "normal"],
                augment=AugmentConfig(out_size=image_size,
                                      hflip_p=0.5, vflip_p=0.3),
                paired_mode=False, raw_mode=raw, uint8_output=True,
            )
            loader = DataLoader(ds, batch, shuffle=True, num_workers=4,
                                drop_last=True, prefetch=3)
            if len(loader) < 2:
                raise RuntimeError(
                    f"e2e epoch of {len(loader)} batches (the loader would "
                    f"restart on every batch)")
            engine.train_epoch(loader, progress=False)  # warm-up epoch
            epochs = []
            for _ in range(3):
                avg = engine.train_epoch(loader, progress=False)[1]
                epochs.append((avg["images_per_sec"],
                               dict(engine.epoch_phases)))
            rate, phases = sorted(epochs, key=lambda e: e[0])[1]
            out = {"images_per_sec": round(rate, 3),
                   "batches_per_epoch": len(loader)}
            out.update({k: round(v, 1) for k, v in phases.items()})
            return out
        finally:
            _ds_mod.set_decode_cache(None)
            if loader is not None:
                loader.close()


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — bench must always emit one line
        print(json.dumps({
            "metric": "bench_error",
            "value": 0.0,
            "unit": "images/sec",
            "vs_baseline": 0.0,
            "error": f"{type(e).__name__}: {e}",
        }))
        sys.exit(1)
