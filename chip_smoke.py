#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vae_cyclegan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (Hopper: the
kernels are built for sm_90a) and nvcc. Phases, one line per finding:

  1. card:    the card's name and power limit (nvidia-smi); fails without CUDA
  2. build:   compiles csrc/*.cu into build/kernels/ (ptxas report in
              chiprun_out/build.log)
  3. kernels: each hand-written kernel against its plain PyTorch version on
              the card, at the serving and training paths' shapes and at
              edge shapes: IN+act, the conv in its three padding modes, the
              weight gradient, and the conv's and the norm's autograd
              Functions against autograd of their plain versions
  4. slice:   the cyclevaegan generator at full width (256x256, base 64,
              latent 64, bf16, seeded random weights) serves requests at
              batch 1, 4 and 16 through run_inference; every generator
              forward must launch the IN+act kernel 5 times and the conv
              kernel 2 times; the f32 and the bf16 forward on the card must
              agree with the port's plain CPU forward in the same dtype, on
              the same weights and noise
  5. train:   the full-width bf16 task takes three train_steps at batch 4;
              each step must launch IN+act 46 times, the reflect conv 12, the
              zero_same conv 14 and the weight gradient 18 times; losses
              finite, no skipped update, every parameter moved; then one f32
              train_step at batch 1 on the card against the port's CPU step
              from the same weights and noise (metrics, spectral vectors,
              parameters within one Adam step), and eval_step
  6. times:   kernel vs plain (CUDA events), request latency per batch size
              and training step time at batch 4 and 24 (host clock, median),
              device busy time and idle share, peak device memory, profiler
              summaries (a device time the profiler did not record in three
              sessions is printed as not measured and left out of the
              summary; the CUDA-event times are always taken)

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
from vae_cyclegan_tpu_torch.models.tasks.cyclegan import GEN_PASSES
from vae_cyclegan_tpu_torch.ops.instance_norm import (
    ORDERS,
    fused_reference,
    in_act_cuda,
    instance_norm_act,
)
from vae_cyclegan_tpu_torch.ops.reflect_conv import reflect_conv
from vae_cyclegan_tpu_torch.ops.starved_conv import (
    dw_cuda,
    dw_reference,
    reflect_conv_cuda,
    rotate,
    starved_reflect_conv,
    zero_conv,
    zero_conv_cuda,
)

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
# the training path's starved convs at 256x256: (name, cin, cout, k)
TRAIN_CONVS = [("head", 3, BASE, 7), ("U4", BASE // 2, BASE, 3),
               ("tail", BASE, 3, 7)]
# launches per train_step, (in_act, reflect conv, zero_same conv, dw):
# 6 generator passes x 5 IN sites + 8 discriminator passes x 2; U4 and tail
# forward in each generator pass; dx of U4 and the tail in every pass and of
# the head where its input is a generator output (F(Gx), G(Fy)); dw of the
# three convs in every pass (tests/test_torch_train.py holds the same counts
# against the JAX package's TPU trace)
STEP_LAUNCHES = (46, 12, 14, 18)
TRAIN_BATCHES = (PATH_BATCH, 24)   # 24: bench.py's default batch
# the f32 step on the card against the port's CPU step: every metric within
# rtol 2e-3 (the forward's summation-order band, widened by exp(logvar) in
# the KL), the spectral vectors within 1e-5 (power iterations on the same
# weights), every parameter within one Adam step of the CPU's (2 lr: after
# one step, an element whose gradient is rounding noise may move +lr on one
# side and -lr on the other), and at most 5% of the elements further apart
# than rounding (1e-6): the generator step's gradient is chaotic in f32 at
# random weights (the JAX package's own f32 and f64 gradients differ by
# 4-60% per tensor at 32-128 px), so some signs flip, but few
STEP_METRIC_RTOL = 2e-3
STEP_SPECTRAL_ATOL = 1e-5
STEP_PARAM_SHARE = 0.05


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def randn(shape, seed: int, dtype=torch.float32, scale: float = 1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(DEV, dtype)


def compare(label: str, got: torch.Tensor, want: torch.Tensor,
            tol=None) -> float:
    atol, rtol = tol or TOL[want.dtype]
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{label}: {tuple(got.shape)}/{got.dtype} vs "
            f"{tuple(want.shape)}/{want.dtype}")
    g, w = got.detach().float(), want.detach().float()
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


PROFILE_TRIES = 3


def profiled(fn, iters: int):
    """Runs `fn` `iters` times under torch.profiler. Returns the summed
    duration of the GPU kernels it launched, per call (what the device
    spends, without the host's launch gaps), and the key averages. A session
    that records no device activity at all (CUPTI now and then hands back an
    empty buffer; the timings from CUDA events are unaffected) is run again,
    up to PROFILE_TRIES times; after that the device time is None: not
    measured."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters, events
        say(f"profiler: a session over {iters} calls saw no device time")
    return None, events


def ms_text(ms, digits: int = 4) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f}"


def kernel_vs_plain(kernel_fn, plain_fn, iters: int) -> dict:
    """Per call, warmed up: the CUDA-event time of a loop of `iters` calls
    (host launch cost included where the host is the slower side), timed
    in the order plain, kernel, kernel, plain; then the device time, where
    the profiler saw it."""
    for fn in (plain_fn, kernel_fn):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "device_ms": profiled(kernel_fn, iters)[0],
            "plain_device_ms": profiled(plain_fn, iters)[0]}


def measured(t: dict) -> dict:
    """The numbers of a kernel_vs_plain result that were measured."""
    return {key: v for key, v in t.items() if v is not None}


def add_times(total: dict | None, t: dict) -> dict:
    """Sums two kernel_vs_plain results key by key; a device time that was
    not measured on either side stays not measured."""
    if total is None:
        return dict(t)
    return {key: None if total[key] is None or t[key] is None
            else total[key] + t[key] for key in t}


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


def phase_train_kernels() -> dict:
    """The training path's kernels against their plain versions: the conv in
    its zero-padded modes (dx convs: g with the rotated weight), the weight
    gradient, and the two autograd Functions against autograd of the plain
    ops, at the path's shapes at batch 4 and at CONV_CASES."""
    errs = {"starved_conv_zero_same": 0.0, "starved_conv_zero": 0.0,
            "starved_conv_dw": 0.0}
    b16, f32 = torch.bfloat16, torch.float32
    convs = [((PATH_BATCH, cin, IMAGE, IMAGE), (cout, cin, k))
             for _, cin, cout, k in TRAIN_CONVS]
    convs += [((2, cin, h, w), (cout, cin, k))
              for h, w, cin, cout, k in CONV_CASES]
    for i, (xs, (cout, cin, k)) in enumerate(convs):
        n, _, h, w = xs
        for dtype in (b16, f32):
            label = f"x{xs} w{(cout, cin, k, k)} {str(dtype)[6:]}"
            x = randn(xs, 300 + i, dtype)
            g = randn((n, cout, h, w), 400 + i, dtype)
            wgt = randn((cout, cin, k, k), 500 + i, dtype,
                        scale=(2.0 / (cout * k * k)) ** 0.5)
            wrot = rotate(wgt).contiguous()
            for mode in ("zero_same", "zero"):
                err = compare(f"starved_conv {mode} g{(n, cout, h, w)} "
                              f"wrot{tuple(wrot.shape)} {str(dtype)[6:]}",
                              zero_conv_cuda(g, wrot, mode),
                              zero_conv(g, wrot, mode))
                key = f"starved_conv_{mode}"
                errs[key] = max(errs[key], err)
            # dw: f32 out of both, summed in another order over n*h*w
            # products (the bf16 inputs are the same values in both)
            want = dw_reference(x, g, k)
            scale = float(want.abs().max())
            err = compare(f"starved_conv_dw {label}", dw_cuda(x, g, k), want,
                          tol=(1e-4 * scale, 0.0))
            errs["starved_conv_dw"] = max(errs["starved_conv_dw"], err)
            # the conv's autograd Function against autograd of the plain
            # conv. bf16 dx: the fold rounds its interior and each border
            # strip to bf16 before adding them (as JAX does), so a border
            # element may be off by a rounding of its largest term: one ulp
            # at dx's largest magnitude plus two of its own
            xa, wa = x.clone().requires_grad_(), wgt.clone().requires_grad_()
            y = starved_reflect_conv(xa, wa)
            dx, dw = torch.autograd.grad(y, (xa, wa), g)
            xb, wb = x.clone().requires_grad_(), wgt.clone().requires_grad_()
            y_ref = reflect_conv(xb, wb)
            dx_ref, dw_ref = torch.autograd.grad(y_ref, (xb, wb), g)
            compare(f"conv Function y {label}", y, y_ref)
            compare(f"conv Function dx {label}", dx, dx_ref,
                    tol=None if dtype == f32 else (
                        2.0 ** -7 * float(dx_ref.abs().max()), 2.0 ** -6))
            rel = 1e-4 if dtype == f32 else 1e-2
            compare(f"conv Function dw {label}", dw, dw_ref,
                    tol=(rel * float(dw_ref.abs().max()), 0.0))
    # the norm's autograd Functions: a kernel site and a big slab
    for i, shape in enumerate([(PATH_BATCH, 16 * BASE, 16, 16),
                               (PATH_BATCH, BASE, IMAGE // 2, IMAGE // 2)]):
        for dtype in (b16, f32):
            for act, order in (("relu", "act_norm"), ("identity", "act_norm"),
                               ("leaky_relu", "norm_act")):
                x = randn(shape, 600 + i, dtype, scale=2.0) + 0.5
                gy = randn(shape, 700 + i, dtype)
                xa = x.clone().requires_grad_()
                y = instance_norm_act(xa, act=act, order=order)
                (dx,) = torch.autograd.grad(y, xa, gy)
                xb = x.clone().requires_grad_()
                y_ref = fused_reference(xb, act, order)
                (dx_ref,) = torch.autograd.grad(y_ref, xb, gy)
                label = f"IN Function {shape} {str(dtype)[6:]} {act}/{order}"
                compare(f"{label} y", y, y_ref)
                compare(f"{label} dx", dx, dx_ref)
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


def _images(batch: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(batch, IMAGE, IMAGE,
                                            3).astype(np.float32)


def _counts() -> tuple:
    return (in_act_cuda.launches, reflect_conv_cuda.launches,
            zero_conv_cuda.launches, dw_cuda.launches)


def _zero_counts() -> None:
    for fn in (in_act_cuda, reflect_conv_cuda, zero_conv_cuda, dw_cuda):
        fn.launches = 0


def _finite_metrics(metrics: dict) -> dict:
    vals = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
    require(all(np.isfinite(v) for v in vals.values()),
            f"finite metrics: {vals}")
    return vals


def phase_train() -> dict:
    """The training path: three train_steps of the full-width bf16 task at
    batch 4, launch counts per step, then eval_step."""
    task = _task(torch.bfloat16, DEV)
    batch = {"x": torch.as_tensor(_images(PATH_BATCH, 10), device=DEV),
             "y": torch.as_tensor(_images(PATH_BATCH, 11), device=DEV)}
    gen = torch.Generator(device=DEV).manual_seed(0)
    start = {n: p.detach().clone() for n, p in task.nets.named_parameters()}
    torch.cuda.synchronize()

    # the main path: the counts cover exactly these steps
    _zero_counts()
    for step in range(3):
        before = _counts()
        vals = _finite_metrics(task.train_step(batch, generator=gen))
        per = tuple(a - b for a, b in zip(_counts(), before))
        require(per == STEP_LAUNCHES,
                f"step {step}: {per} launches of (in_act, reflect conv, "
                f"zero_same conv, dw), expected {STEP_LAUNCHES}")
        require(vals["nan_detected"] == 0.0, f"step {step} skipped an update")
        say(f"train step {step} (bf16, batch {PATH_BATCH}): G_loss "
            f"{vals['G_loss']:.4f}, D_loss {vals['D_loss']:.4f}, loss_kl "
            f"{vals['loss_kl']:.2f}, nan_detected 0; launches {per} ok")
    launches = dict(zip(("in_act", "starved_conv", "starved_conv_zero_same",
                         "starved_conv_dw"), _counts()))
    stuck = [n for n, p in task.nets.named_parameters()
             if torch.equal(p, start[n])]
    require(not stuck, f"parameters that did not move: {stuck}")
    say(f"train: 3 steps, launches {launches}; all {len(start)} parameter "
        f"tensors moved")
    metrics = task.eval_step(batch, generator=gen)
    _finite_metrics(metrics)
    for key in ("Gx", "Fy"):
        out = metrics[key]
        require(tuple(out.shape) == (PATH_BATCH, IMAGE, IMAGE, 3)
                and bool(torch.isfinite(out).all()),
                f"eval_step {key} {tuple(out.shape)} finite")
    say(f"eval_step: G_loss {float(metrics['G_loss']):.4f}, Gx and Fy "
        f"{tuple(metrics['Gx'].shape)} finite")
    return {"task": task, "launches": launches}


def phase_train_f32() -> None:
    """One f32 train_step at batch 1 on the card (TF32 off) against the
    port's CPU step from the same weights, batch and noise."""
    rng = np.random.RandomState(20)
    batch = {"x": _images(1, 21), "y": _images(1, 22)}
    eps = [rng.randn(1, IMAGE // 16, IMAGE // 16, LATENT).astype(np.float32)
           for _ in GEN_PASSES]
    gpu, cpu = _task(torch.float32, DEV), _task(torch.float32, "cpu")
    got = _finite_metrics(gpu.train_step(batch, eps=eps))
    t0 = time.perf_counter()
    want = _finite_metrics(cpu.train_step(batch, eps=eps))
    cpu_s = time.perf_counter() - t0
    worst = max(abs(got[k] - want[k]) / (abs(want[k]) + 1e-3) for k in want)
    ok = all(abs(got[k] - want[k]) <= STEP_METRIC_RTOL * abs(want[k]) + 1e-5
             for k in want)
    say(f"check train_step f32 card vs CPU (batch 1, TF32 off, CPU step "
        f"{cpu_s:.1f} s): metrics max relative error {worst:.3e} (rtol "
        f"{STEP_METRIC_RTOL:g}, atol 1e-5) {'ok' if ok else 'FAIL'}")
    require(ok, f"train_step metrics card vs CPU: {got} vs {want}")
    lr = gpu.oc.lr
    gsd, csd = gpu.state_dict(), cpu.state_dict()
    spec, par, n, beyond_round, flipped = 0.0, 0.0, 0, 0, 0
    for name, c in csd.items():
        d = (gsd[name].cpu() - c).abs()
        if name.endswith(("weight_u", "weight_v")):
            spec = max(spec, float(d.max()))
            continue
        par = max(par, float(d.max()))
        n += d.numel()
        beyond_round += int((d > 1e-6).sum())
        flipped += int((d > lr).sum())
    say(f"check train_step f32 card vs CPU: spectral u/v max_abs_err "
        f"{spec:.3e} (atol {STEP_SPECTRAL_ATOL:g}); parameters max_abs_err "
        f"{par:.3e} = {par / lr:.3f} lr (bound 2 lr + 1e-6); "
        f"{beyond_round / n:.4f} of {n} elements differ by more than 1e-6 "
        f"(bound {STEP_PARAM_SHARE:g}), "
        f"{flipped / n:.4f} by more than lr (opposite Adam signs)")
    require(spec <= STEP_SPECTRAL_ATOL, "spectral vectors card vs CPU")
    require(par <= 2 * lr + 1e-6, "parameters card vs CPU within one Adam step")
    require(beyond_round / n <= STEP_PARAM_SHARE,
            f"parameters card vs CPU: more than {STEP_PARAM_SHARE:g} of the "
            "elements differ beyond rounding")


def phase_train_times(card: str, tr: dict) -> dict:
    b16 = torch.bfloat16
    times = {}

    def show(label, t):
        say(f"time {label} bf16: kernel {t['ms']:.4f} ms (device "
            f"{ms_text(t['device_ms'])}), plain {t['plain_ms']:.4f} ms "
            f"(device {ms_text(t['plain_device_ms'])}) [{card}]")

    # the new kernels at the training path's shapes, batch 4
    dx_total = dw_total = None
    for name, cin, cout, k in TRAIN_CONVS:
        x = randn((PATH_BATCH, cin, IMAGE, IMAGE), 30, b16)
        g = randn((PATH_BATCH, cout, IMAGE, IMAGE), 31, b16)
        wrot = rotate(randn((cout, cin, k, k), 32, b16, 0.05)).contiguous()
        t = kernel_vs_plain(lambda: zero_conv_cuda(g, wrot),
                            lambda: zero_conv(g, wrot), 10)
        show(f"starved_conv zero_same {name} dx g{tuple(g.shape)} "
             f"wrot{tuple(wrot.shape)}", t)
        dx_total = add_times(dx_total, t)
        t = kernel_vs_plain(lambda: dw_cuda(x, g, k),
                            lambda: dw_reference(x, g, k), 10)
        show(f"starved_conv_dw {name} x{tuple(x.shape)} g{tuple(g.shape)} "
             f"k{k}", t)
        dw_total = add_times(dw_total, t)
    times["starved_conv_zero_same"] = dx_total
    times["starved_conv_dw"] = dw_total

    # training step time, device busy time and peak memory per batch size
    task = tr["task"]
    gen = torch.Generator(device=DEV).manual_seed(1)
    for b in TRAIN_BATCHES:
        batch = {"x": torch.as_tensor(_images(b, 40 + b), device=DEV),
                 "y": torch.as_tensor(_images(b, 41 + b), device=DEV)}
        for _ in range(2):
            task.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            vals = _finite_metrics(task.train_step(batch, generator=gen))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            require(vals["nan_detected"] == 0.0, "timed step skipped")
        med = float(np.median(lat))
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        # device busy time and where it goes, by kernel, over 2 steps
        busy, events = profiled(lambda: task.train_step(batch, generator=gen),
                                2)
        idle = "not measured" if busy is None else \
            f"{max(0.0, 1 - busy / med):.3f}"
        times[("train", b)] = med
        say(f"time train_step batch {b} bf16: median {med:.2f} ms of "
            f"{len(lat)} (min {min(lat):.2f}, max {max(lat):.2f}), "
            f"{b / med * 1e3:.1f} img/s, device busy {ms_text(busy, 2)} ms "
            f"per step (idle share {idle}), peak memory {peak:.0f} MiB "
            f"[{card}]")
        table = events.table(sort_by="self_cuda_time_total", row_limit=45)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"profile_train_batch{b}.txt").write_text(table)
        say(f"profile (train_step, batch {b}, 2 steps; top self device time, "
            f"full table in chiprun_out/profile_train_batch{b}.txt):")
        for line in table.splitlines()[:20]:
            say(f"  {line}")
    return times


def phase_times(card: str, sl: dict) -> dict:
    b16 = torch.bfloat16
    times = {}

    def show(label, t):
        say(f"time {label} bf16: kernel {t['ms']:.4f} ms (device "
            f"{ms_text(t['device_ms'])}), plain {t['plain_ms']:.4f} ms "
            f"(device {ms_text(t['plain_device_ms'])}) [{card}]")

    # kernels at the path shapes (batch 4 and 16, bf16)
    for b in (PATH_BATCH, 16):
        x = randn((b, 16 * BASE, IMAGE // 16, IMAGE // 16), 7, b16)
        t = kernel_vs_plain(lambda: in_act_cuda(x, "relu", "act_norm"),
                            lambda: fused_reference(x, "relu", "act_norm"),
                            200)
        times[("in_act", b)] = t
        show(f"in_act {tuple(x.shape)}", t)
        total = None
        for name, cin, cout, kk in (("U4", BASE // 2, BASE, 3),
                                    ("tail", BASE, 3, 7)):
            x = randn((b, cin, IMAGE, IMAGE), 8, b16)
            w = randn((cout, cin, kk, kk), 9, b16, 0.05)
            t = kernel_vs_plain(lambda: reflect_conv_cuda(x, w),
                                lambda: reflect_conv(x, w), 20)
            show(f"starved_conv {name} x{tuple(x.shape)} w{tuple(w.shape)}", t)
            total = add_times(total, t)
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
        busy = profiled(lambda: task.generate({"x": x}, generator=gen), 5)[0]
        idle = "not measured" if busy is None else \
            f"{max(0.0, 1 - busy / med):.2f}"
        times[("slice", b)] = med
        say(f"time slice generate batch {b} bf16: median {med:.3f} ms of "
            f"{len(lat)} (min {min(lat):.3f}, max {max(lat):.3f}), "
            f"{b / med * 1e3:.1f} img/s, device busy {ms_text(busy, 3)} ms "
            f"per request (idle share {idle}), peak memory {peak:.0f} MiB, "
            f"{peak - f_mib:.0f} MiB without F's unread weights "
            f"({f_mib:.1f} MiB) [{card}]")

    # where the device time of batch-4 requests goes, by kernel
    x = torch.as_tensor(np.random.RandomState(0).rand(
        PATH_BATCH, IMAGE, IMAGE, 3).astype(np.float32), device=DEV)
    events = profiled(lambda: task.generate({"x": x}), 5)[1]
    table = events.table(sort_by="self_cuda_time_total", row_limit=30)
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
    errs.update(phase_train_kernels())
    sl = phase_slice()
    times = phase_times(card, sl)
    del sl
    tr = phase_train()
    phase_train_f32()
    times.update(phase_train_times(card, tr))
    launches = tr["launches"]  # the training path's three steps
    conv_src = "vae_cyclegan_tpu_torch/csrc/starved_conv.cu"
    summary = {"kernels": [
        {"name": "in_act", "route": "cuda",
         "source": "vae_cyclegan_tpu_torch/csrc/in_act.cu",
         "replaces": "vae_cyclegan_tpu/ops/instance_norm.py:110",
         "launches": launches["in_act"],
         "max_abs_err": errs["in_act"],
         **measured(times[("in_act", PATH_BATCH)])},
        {"name": "starved_conv", "route": "cuda", "source": conv_src,
         "replaces": "vae_cyclegan_tpu/ops/starved_conv.py:279",
         "launches": launches["starved_conv"],
         "max_abs_err": errs["starved_conv"],
         # U4 + tail: one generator forward's two sites at batch 4
         **measured(times[("starved_conv", PATH_BATCH)])},
        {"name": "starved_conv_zero_same", "route": "cuda", "source": conv_src,
         "replaces": "vae_cyclegan_tpu/ops/starved_conv.py:279",
         "launches": launches["starved_conv_zero_same"],
         "max_abs_err": errs["starved_conv_zero_same"],
         # head + U4 + tail dx at batch 4
         **measured(times["starved_conv_zero_same"])},
        {"name": "starved_conv_dw", "route": "cuda",
         "source": "vae_cyclegan_tpu_torch/csrc/starved_dw.cu",
         "replaces": "vae_cyclegan_tpu/ops/starved_conv.py:394",
         "launches": launches["starved_conv_dw"],
         "max_abs_err": errs["starved_conv_dw"],
         # head + U4 + tail dw at batch 4
         **measured(times["starved_conv_dw"])},
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
