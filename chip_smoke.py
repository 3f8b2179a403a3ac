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
              edge shapes: IN+act (K1, centered variance, and K2, single-pass;
              both also at the edges of their regimes, in bf16 and f32 with
              every activation and order, each case repeated bit for bit),
              the conv in its three
              padding modes (also at shapes that cross its tiles, and bit
              for bit on a second launch), the weight gradient (also at
              shapes that cross its tiles, bit for bit on a second launch),
              and the conv's and the norm's autograd Functions against
              autograd of their plain versions
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
              finite, no skipped update, every parameter moved; eval_step
              and generate; then one f32 train_step at batch 1 on the card
              against the port's CPU step from the same weights and noise
              (metrics, spectral vectors, parameters within one Adam step)
  6. tiled:   the same under instance_norm="tiled": each step launches the
              tiled IN kernel (K2) 96 times and K1 never, the
              convs as in 5; the f32 step against the CPU's; step times
  7. families: the nine other architectures at full width, bf16, batch 4:
              two train_steps each (launches per step as the CPU site tests
              derive from the JAX TPU trace), eval_step, generate, a step
              time; and one f32 step each on the card against the port's CPU
              step at image 64, base 16
  8. experiments: the four conv prototypes of experiments/ (K5-K8): each
              kernel against its plain version at the prototypes' shapes
              (batch 24, bf16) and at edge shapes (f32 and bf16), bit for bit
              on a second launch, R not dividing h refused; then each
              prototype's entry point (``main``) at its default batch, 24,
              whose calls must equal its kernel's launches; kernel, plain
              version and library call timed at the prototypes' shapes
  9. times:   kernel vs plain vs the library call (CUDA events), each
              kernel's bound (bytes over HBM bandwidth or operations over
              the peak rate, whichever is larger), the two IN kernels and
              the plain versions at every tiled site at batch 4 and 24
              (events, device time, the wrappers' host time per call, the
              byte bound; F.instance_norm at the identity sites), request
              latency per
              batch size and training step time at batch 4 and 24 (host
              clock, median), device busy time and idle share, peak device
              memory, profiler summaries (a device time the profiler did not
              record in three profiler runs is printed as not measured and left
              out of the summary; the CUDA-event times are always taken),
              and per training step each hand kernel's device time (a
              kernel that launched must show in a profile that saw the
              device), with the IN kernels' byte bound per step

Each main path (the serving requests, each training run) is driven with
every launch count set to 0 just before it and read just after it. Any
failed check raises, and the script exits non-zero without printing its last
line, ``{"ok": true, "device": {...}}``. The line before it names the card,
and the one before that is the ``{"kernels": [...]}`` summary.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.experiments import (
    conv_proto,
    dw_dot_probe,
    lowcin_conv2,
    lowcin_conv3,
)
from vae_cyclegan_tpu_torch.experiments.common import (
    conv_operands,
    reflect_conv_reference,
)
from vae_cyclegan_tpu_torch.inference import run_inference
from vae_cyclegan_tpu_torch.models.tasks import ARCHITECTURES, create_task
from vae_cyclegan_tpu_torch.ops.instance_norm import (
    ORDERS,
    fused_reference,
    in_act_cuda,
    in_act_tiled_cuda,
    instance_norm_act,
    plane_plan,
    slab_fits,
    tiled_reference,
)
from vae_cyclegan_tpu_torch.ops.padding import reflect_pad
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
# the conv kernel's edges (tests/test_torch_kernels.py K3_EDGES), (h, w,
# cin, cout, k): cout past one N tile and not a multiple of it, h not a
# multiple of the tile's rows, w not a multiple of its columns nor (45) of
# the 16-byte loads, with and without the taps folded into N (bf16, k *
# cout <= 24), and cin 128 and 256, whose K loops walk two channel chunks
K3_EDGES = [(38, 72, 16, 80, 3), (35, 45, 5, 24, 5), (35, 45, 8, 3, 5),
            (34, 40, 128, 3, 7), (32, 40, 256, 16, 3)]
# the dw kernel's edges (tests/test_torch_kernels.py DW_EDGES), (n, h, w,
# cin, cout, k): cout 24 and 80 past its M tiles of 64, cin*k*k 125 and 144
# and cin 256 (16 tiles) across its N tiles of up to 160, the folded tail's
# wide M (cin 128: 8 tiles of up to 128 rows), odd h and w (rows staged
# element by element), rows past one 256-column chunk (520; 264 with a last
# chunk of 8), n = 1
DW_EDGES = [(1, 35, 45, 5, 24, 5), (2, 38, 72, 16, 80, 3),
            (1, 34, 40, 128, 3, 7), (2, 32, 40, 256, 16, 3),
            (1, 35, 45, 8, 3, 5), (1, 16, 520, 4, 16, 3),
            (1, 12, 264, 8, 3, 7)]
DEV = torch.device("cuda")
# the training path's starved convs at 256x256: (name, cin, cout, k)
TRAIN_CONVS = [("head", 3, BASE, 7), ("U4", BASE // 2, BASE, 3),
               ("tail", BASE, 3, 7)]
# the kernels' wrappers, each with its launch count, and their names in the
# summary line
WRAPPERS = (in_act_cuda, in_act_tiled_cuda, reflect_conv_cuda, zero_conv_cuda,
            dw_cuda)
KERNEL_NAMES = ("in_act", "in_act_tiled", "starved_conv",
                "starved_conv_zero_same", "starved_conv_dw")
# launches per train_step in WRAPPERS order. cyclevaegan: 6 generator passes
# x 5 IN sites + 8 discriminator passes x 2; U4 and tail forward in each
# generator pass; dx of U4 and the tail in every pass and of the head where
# its input is a generator output (F(Gx), G(Fy)); dw of the three convs in
# every pass. Under "tiled" the tiled kernel takes 12 of a generator
# pass's 13 IN sites (not U4's) and a discriminator pass's 3. The CPU site
# tests hold the same counts against the JAX package's TPU trace
# (tests/test_torch_train.py, test_torch_tiled.py, test_torch_families_*.py)
STEP_LAUNCHES = (46, 0, 12, 14, 18)
TILED_STEP_LAUNCHES = (0, 96, 12, 14, 18)
FAMILY_STEP_LAUNCHES = {
    "autoencoder": (5, 0, 2, 2, 3), "vae": (5, 0, 2, 2, 3),
    "doubleae": (10, 0, 4, 4, 6), "doublevae": (10, 0, 4, 4, 6),
    "aegan": (18, 0, 4, 4, 6), "vaegan": (18, 0, 4, 4, 6),
    "cycleae": (20, 0, 8, 10, 12), "cyclevae": (20, 0, 8, 10, 12),
    "cycleaegan": (46, 0, 12, 14, 18),
}
TRAIN_BATCHES = (PATH_BATCH, 24)   # 24: bench.py's default batch
# the tiled IN kernel's sites at batch 4, (shape, act, order): the
# generator's (CaSb head, D blocks, R block, U blocks) and the
# discriminator's (its three normalized CaSb)
TILED_SITES = [
    ((PATH_BATCH, BASE, IMAGE, IMAGE), "relu", "norm_act"),
    ((PATH_BATCH, 2 * BASE, IMAGE // 2, IMAGE // 2), "relu", "act_norm"),
    ((PATH_BATCH, 4 * BASE, IMAGE // 4, IMAGE // 4), "relu", "act_norm"),
    ((PATH_BATCH, 8 * BASE, IMAGE // 8, IMAGE // 8), "relu", "act_norm"),
    ((PATH_BATCH, 16 * BASE, IMAGE // 16, IMAGE // 16), "relu", "act_norm"),
    ((PATH_BATCH, 16 * BASE, IMAGE // 16, IMAGE // 16), "identity",
     "act_norm"),
    ((PATH_BATCH, 2 * BASE, IMAGE // 4, IMAGE // 4), "leaky_relu",
     "norm_act"),
    ((PATH_BATCH, 4 * BASE, IMAGE // 8, IMAGE // 8), "leaky_relu",
     "norm_act"),
    ((PATH_BATCH, 8 * BASE, IMAGE // 16, IMAGE // 16), "leaky_relu",
     "norm_act"),
]
# planes of 72x72 (a multiple of the 16-byte vector) and 75x67 (not one)
TILED_EDGES = [(2, 16, 72, 72), (2, 3, 75, 67)]
# The IN kernels' regimes (csrc/in_plane.cuh) by bytes per plane: a warp per
# plane up to 2 KB, a CTA per plane up to 32 KB, a thread block cluster per
# plane up to 256 KB, a cluster looping over the plane beyond
PLANE_LIMITS = ((2 * 1024, "warp"), (32 * 1024, "block"),
                (256 * 1024, "cluster"))
# the RBlocks' identity sites, where F.instance_norm computes the same
# function as the IN kernels
IDENTITY_SITE = (PATH_BATCH, 16 * BASE, IMAGE // 16, IMAGE // 16)
# the nine other architectures' f32 step on the card against the CPU's, at
# (image, latent, base) and batch 2: at most this share of the parameter
# elements may take the other Adam sign (the bounds of the CPU tests against
# JAX, tests/test_torch_families_*.py; at random weights the generator
# step's f32 gradient is chaotic, ROADMAP.md queue 3)
FAMILY_F32_SIZE = (64, 16, 16)
FAMILY_FLIPPED = {"autoencoder": 0.03, "vae": 0.01, "doubleae": 0.04,
                  "doublevae": 0.01, "aegan": 0.02, "vaegan": 0.01,
                  "cycleae": 0.03, "cyclevae": 0.25, "cycleaegan": 0.04}
# the card's published peaks (NVIDIA's H100 SXM data sheet, dense, at
# 700 W): HBM bandwidth, bf16 tensor-core and f32
# CUDA-core rates, per millisecond. The IN kernels' arithmetic is f32 on the
# CUDA cores; the convs' inputs are bf16, held to the bf16 tensor-core rate
HBM_BYTES_PER_MS = 3.35e12 / 1e3
PEAK_OPS_PER_MS = {"bf16": 989e12 / 1e3, "f32": 67e12 / 1e3}
# IN+act per element: the activation, a sum, a square and its sum, then a
# subtract and a multiply
IN_OPS_PER_ELEMENT = 6
# the f32 step on the card against the port's CPU step: every metric within
# rtol 2e-3 (the forward's summation-order band, widened by exp(logvar) in
# the KL), the spectral vectors within 1e-5 (power iterations on the same
# weights), every parameter within one Adam step of the CPU's (2 lr: after
# one step, an element whose gradient is rounding noise may move +lr on one
# side and -lr on the other), and at most 5% of the elements further apart
# than rounding (1e-6): the generator step's gradient is chaotic in f32 at
# random weights (the JAX package's own f32 and f64 gradients differ by
# 4-60% per tensor at 32-128 px), so some signs flip, but few
# the conv prototypes' kernels (K5-K8), each wrapper with its launch count,
# and their names in the summary line
EXP_WRAPPERS = (conv_proto.conv_proto_cuda, lowcin_conv2.lowcin_conv_cm_cuda,
                lowcin_conv3.lowcin_conv_nhwc_cuda, dw_dot_probe.dot_probe_cuda)
EXP_NAMES = ("conv_proto", "lowcin_conv_cm", "lowcin_conv_nhwc", "dot_probe")
# the prototypes' conv kernels: (name, entry point module, wrapper, plain
# version in the kernel's own output layout, the TPU kernel)
EXP_CONVS = (
    ("conv_proto", conv_proto, conv_proto.conv_proto_cuda,
     reflect_conv_reference, "experiments/pallas_conv_proto.py:51"),
    ("lowcin_conv_cm", lowcin_conv2, lowcin_conv2.lowcin_conv_cm_cuda,
     lowcin_conv2.lowcin_conv_cm_reference, "experiments/pallas_conv2.py:85"),
    ("lowcin_conv_nhwc", lowcin_conv3, lowcin_conv3.lowcin_conv_nhwc_cuda,
     reflect_conv_reference, "experiments/pallas_conv3.py:87"),
)
# each conv kernel's CUDA function, as the profiler names it
EXP_KERNEL_NAMES = {"conv_proto": "conv_proto_kernel",
                    "lowcin_conv_cm": "lowcin_kernel",
                    "lowcin_conv_nhwc": "lowcin_kernel"}
EXP_BATCH = 24   # the prototypes' batch
# edge shapes (h, w, cin, cout, k, R): k = 7, 5, 3; cin = 3, 5, 8; widths
# off the multiple of 8; two R per shape; cout = 3 takes the narrow tiles
EXP_EDGES = [(16, 20, 3, 8, 7, 8), (16, 20, 3, 8, 7, 16), (24, 30, 5, 6, 5, 8),
             (24, 30, 5, 6, 5, 12), (32, 36, 8, 16, 3, 16),
             (32, 36, 8, 16, 3, 4), (16, 24, 64, 3, 7, 8)]
# K8's edges (mk, nk, kk, steps): both tile orientations, ragged M, N, K
PROBE_EDGES = [(24, 40, 100, 3), (40, 24, 77, 2)]
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


def dev_randn(shape, seed: int, dtype=torch.float32, scale: float = 1.0):
    """randn drawn on the card (the prototypes' operands at batch 24 are
    10^8 elements)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=DEV) * scale).to(dtype)


def compare(label: str, got: torch.Tensor, want: torch.Tensor,
            tol=None, quiet: bool = False) -> float:
    """|got - want| <= atol + rtol |want| everywhere, got finite; prints a
    line (only on failure when `quiet`), raises on failure, returns the
    largest error."""
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
    if not (quiet and ok):
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


def kernel_device_ms(fn, iters: int, keys):
    """The device time per launch of the CUDA kernels whose profiler names
    hold one of `keys` (a kernel alone, without its wrapper's other work),
    over `iters` calls of `fn` under the profiler: their summed time over
    the launches it recorded (a session can record fewer launches than were
    made, so dividing by the calls would undercount); None where it
    recorded none."""
    events = profiled(fn, iters)[1]
    hits = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(key in e.key for key in keys)]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / n if n else None


def ms_text(ms, digits: int = 4) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f}"


def time_calls(fns: dict, iters: int) -> dict:
    """Per call, warmed up: the CUDA-event time of a loop of `iters` calls of
    each named function (host launch cost included where the host is the
    slower side), timed in turns, in the given order and then reversed, and
    averaged over the two turns."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    order = list(fns)
    ms = dict.fromkeys(order, 0.0)
    for name in order + order[::-1]:
        ms[name] += cuda_ms(fns[name], iters) / 2
    return ms


def kernel_vs_plain(kernel_fn, plain_fn, library_fn, iters: int) -> dict:
    """time_calls of the plain version, the kernel and the library call that
    computes the same function; then the device times of the kernel and the
    plain version, where the profiler saw them."""
    t = time_calls({"plain_ms": plain_fn, "ms": kernel_fn,
                    "library_ms": library_fn}, iters)
    t["device_ms"] = profiled(kernel_fn, iters)[0]
    t["plain_device_ms"] = profiled(plain_fn, iters)[0]
    return t


def measured(t: dict) -> dict:
    """The numbers of a kernel_vs_plain result that were measured."""
    return {key: v for key, v in t.items() if v is not None}


def add_times(total: dict | None, t: dict) -> dict:
    """Sums two kernel_vs_plain results key by key; a time that was not
    measured on either side stays not measured."""
    if total is None:
        return dict(t)
    return {key: None if total[key] is None or t[key] is None
            else total[key] + t[key] for key in t}


def bound(nbytes: float, ops: float, rate: str) -> dict:
    """The least time the card could take for work that must move `nbytes`
    and do `ops` operations at the peak rate `rate`: the larger of the two
    times, and which one it is."""
    by_bytes = nbytes / HBM_BYTES_PER_MS
    by_ops = ops / PEAK_OPS_PER_MS[rate]
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def in_act_bound(shape, dtype) -> dict:
    """IN+act of one NCHW tensor: x read once, y written once."""
    n = int(np.prod(shape))
    size = torch.empty((), dtype=dtype).element_size()
    return bound(2 * n * size, IN_OPS_PER_ELEMENT * n, "f32")


def plane_edges(dtype) -> list:
    """NCHW shapes at the IN kernels' regime edges (tests/test_torch_kernels.py
    PLANE_CASES): each threshold and one 16-byte vector either side (h = the
    vector's elements, w = 128 k - 1, 128 k, 128 k + 1: 2, 32 and 256 KB at
    k = 1, 16, 128), planes whose hw is not a multiple of the vector, and 11
    and 15 planes of 16x16, which do not fill the last block of eight
    warps."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return ([(1, 3, vec, 128 * k + d) for k in (1, 16, 128) for d in (-1, 0, 1)]
            + [(1, 3, 31, 33), (1, 2, 127, 129), (1, 2, 255, 257),
               (1, 2, 363, 363), (1, 11, 16, 16), (3, 5, 16, 16)])


def regime(hw: int, dtype) -> str:
    nbytes = hw * torch.empty((), dtype=dtype).element_size()
    return next((name for limit, name in PLANE_LIMITS if nbytes <= limit),
                "stream")


def check_in_kernel(label: str, kernel, plain, x, act: str, order: str,
                    quiet: bool = False) -> float:
    """An IN kernel against its plain version, then a second launch bit for
    bit (its sums run in a fixed order, no atomics)."""
    got = kernel(x, act, order)
    err = compare(label, got, plain(x, act, order), quiet=quiet)
    require(torch.equal(kernel(x, act, order), got),
            f"{label}: a second launch gave other bits")
    return err


def check_in_edges(name: str, kernel, plain, seed: int) -> float:
    """K1 or K2 at plane_edges in bf16 and f32, every activation and order:
    the plan the library takes is the regime the thresholds name, and each
    case passes check_in_kernel (one summary line; a failure prints its
    case). Also the path's planes: 16x16 ... 256x256 none loops over device
    memory, and 256x256 takes a cluster of 8 CTAs."""
    err, n = 0.0, 0
    for dtype in (torch.bfloat16, torch.float32):
        vec = 16 // torch.empty((), dtype=dtype).element_size()
        for side in (16, 32, 64, 128, 256):
            plan = plane_plan(side * side, dtype)
            require(plan["regime"] == regime(side * side, dtype) != "stream"
                    and (side < 256 or plan["cluster"] == 8),
                    f"{name}: plan of {side}x{side} {dtype}: {plan}")
        for shape in plane_edges(dtype):
            hw = shape[2] * shape[3]
            plan = plane_plan(hw, dtype, hw % vec == 0)
            require(plan["regime"] == regime(hw, dtype),
                    f"{name}: plan of {shape} {dtype}: {plan}")
            x = randn(shape, seed + n, dtype, 2.0) + 0.5
            for act in ACTS:
                for order in ORDERS:
                    label = (f"{name} {shape} {str(dtype)[6:]} {act}/{order} "
                             f"({plan['regime']})")
                    err = max(err, check_in_kernel(label, kernel, plain, x,
                                                   act, order, quiet=True))
                    n += 1
    say(f"{name} at the regimes' edges: {n} cases (bf16 and f32, every "
        f"activation and order), max_abs_err {err:.3e}, each repeated bit "
        "for bit; path planes 16x16-128x128 on chip, 256x256 a cluster of 8")
    return err


def host_us(fn, iters: int) -> float:
    """Host microseconds per call over `iters` calls without a synchronize:
    the wrapper's own cost, while the card runs behind it (where the card is
    the slower side, the launch queue fills and this reads the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def conv_work(x_shape, cout: int, k: int, out_hw, size: int,
              out_size: int) -> tuple:
    """(bytes, multiply-adds x 2) of a k x k conv from NCHW x to cout
    channels over `out_hw` output positions: x and the weight read once, the
    output written once."""
    n, cin, h, w = x_shape
    oh, ow = out_hw
    nbytes = (n * cin * h * w * size + cout * cin * k * k * size
              + n * cout * oh * ow * out_size)
    return nbytes, 2.0 * n * oh * ow * cout * cin * k * k


def sum_bounds(works, rate: str) -> dict:
    """bound() of the summed (bytes, operations) of several calls."""
    return bound(sum(w[0] for w in works), sum(w[1] for w in works), rate)


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


def check_conv(label: str, launch, want: torch.Tensor) -> float:
    """The conv kernel against its plain version, then a second launch bit
    for bit (its K loop sums in one fixed order)."""
    got = launch()
    err = compare(label, got, want)
    require(torch.equal(launch(), got),
            f"{label}: a second launch gave other bits")
    return err


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
        err = check_in_kernel(f"in_act {shape} {str(dtype)[6:]} {act}/{order}",
                              in_act_cuda, fused_reference, x, act, order)
        errs["in_act"] = max(errs["in_act"], err)
    say(f"in_act: {len(cases)} cases, each repeated bit for bit")
    errs["in_act"] = max(errs["in_act"], check_in_edges(
        "in_act", in_act_cuda, fused_reference, 300))
    for dtype in (b16, f32):
        # one element into its storage: not 16-byte aligned, one-element loads
        x = randn((2 * 64 * 32 * 32 + 1,), 299, dtype, 2.0)[1:].view(
            2, 64, 32, 32)
        err = check_in_kernel(f"in_act unaligned view {tuple(x.shape)} "
                              f"{str(dtype)[6:]} relu/act_norm", in_act_cuda,
                              fused_reference, x, "relu", "act_norm")
        errs["in_act"] = max(errs["in_act"], err)

    convs = [((PATH_BATCH, BASE // 2, IMAGE, IMAGE), (BASE, BASE // 2, 3)),
             ((PATH_BATCH, BASE, IMAGE, IMAGE), (3, BASE, 7))]
    convs += [((2, cin, h, w), (cout, cin, k))
              for h, w, cin, cout, k in CONV_CASES + K3_EDGES]
    for i, (xs, (cout, cin, k)) in enumerate(convs):
        for dtype in (b16, f32):
            x = randn(xs, seed=100 + i, dtype=dtype)
            w = randn((cout, cin, k, k), seed=200 + i, dtype=dtype,
                      scale=(2.0 / (cout * k * k)) ** 0.5)
            err = check_conv(f"starved_conv x{xs} w{(cout, cin, k, k)} "
                             f"{str(dtype)[6:]}",
                             lambda: reflect_conv_cuda(x, w),
                             reflect_conv(x, w))
            errs["starved_conv"] = max(errs["starved_conv"], err)
    say(f"starved_conv reflect: {2 * len(convs)} cases, each repeated bit "
        "for bit")
    return errs


def check_dw(label: str, x: torch.Tensor, g: torch.Tensor, k: int) -> float:
    """The weight-gradient kernel against its plain version (f32 out of
    both, summed in another order over n*h*w products; the bf16 inputs are
    the same values in both: within 1e-4 of the largest |dw|), then a
    second launch bit for bit (its partials are summed in a fixed order)."""
    got = dw_cuda(x, g, k)
    want = dw_reference(x, g, k)
    err = compare(f"starved_conv_dw {label}", got, want,
                  tol=(1e-4 * float(want.abs().max()), 0.0))
    require(torch.equal(dw_cuda(x, g, k), got),
            f"starved_conv_dw {label}: a second launch gave other bits")
    return err


def phase_train_kernels() -> dict:
    """The training path's kernels against their plain versions: the conv in
    its zero-padded modes (dx convs: g with the rotated weight; also at
    K3_EDGES, and bit for bit on a second launch), the weight gradient (also
    at DW_EDGES, bit for bit on a second launch), and the two autograd
    Functions against autograd of the plain ops, at the path's shapes at
    batch 4 and at CONV_CASES."""
    errs = {"starved_conv_zero_same": 0.0, "starved_conv_zero": 0.0,
            "starved_conv_dw": 0.0}
    b16, f32 = torch.bfloat16, torch.float32
    convs = [((PATH_BATCH, cin, IMAGE, IMAGE), (cout, cin, k))
             for _, cin, cout, k in TRAIN_CONVS]
    convs += [((2, cin, h, w), (cout, cin, k))
              for h, w, cin, cout, k in CONV_CASES]
    edges = [((2, cin, h, w), (cout, cin, k))
             for h, w, cin, cout, k in K3_EDGES]

    def zero_modes(x, w, dtype):
        for mode in ("zero_same", "zero"):
            err = check_conv(f"starved_conv {mode} x{tuple(x.shape)} "
                             f"w{tuple(w.shape)} {str(dtype)[6:]}",
                             lambda: zero_conv_cuda(x, w, mode),
                             zero_conv(x, w, mode))
            key = f"starved_conv_{mode}"
            errs[key] = max(errs[key], err)

    # the edges as they are (the kernel's cout is the edge's); the path's
    # shapes and CONV_CASES below as dx convs
    for i, (xs, (cout, cin, k)) in enumerate(edges):
        for dtype in (b16, f32):
            zero_modes(randn(xs, 450 + i, dtype),
                       randn((cout, cin, k, k), 550 + i, dtype,
                             scale=(2.0 / (cout * k * k)) ** 0.5), dtype)
    for i, (n, h, w, cin, cout, k) in enumerate(DW_EDGES):
        for dtype in (b16, f32):
            err = check_dw(f"x{(n, cin, h, w)} g{(n, cout, h, w)} k{k} "
                           f"{str(dtype)[6:]}", randn((n, cin, h, w), 460 + i,
                                                      dtype),
                           randn((n, cout, h, w), 560 + i, dtype), k)
            errs["starved_conv_dw"] = max(errs["starved_conv_dw"], err)
    for i, (xs, (cout, cin, k)) in enumerate(convs):
        n, _, h, w = xs
        for dtype in (b16, f32):
            label = f"x{xs} w{(cout, cin, k, k)} {str(dtype)[6:]}"
            x = randn(xs, 300 + i, dtype)
            g = randn((n, cout, h, w), 400 + i, dtype)
            wgt = randn((cout, cin, k, k), 500 + i, dtype,
                        scale=(2.0 / (cout * k * k)) ** 0.5)
            zero_modes(g, rotate(wgt).contiguous(), dtype)
            err = check_dw(label, x, g, k)
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
    say(f"starved_conv zero_same, zero: {4 * (len(convs) + len(edges))} "
        f"cases; starved_conv_dw: {2 * (len(convs) + len(DW_EDGES))} cases; "
        "each repeated bit for bit")
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


def phase_tiled_kernels() -> dict:
    """The tiled IN kernel against tiled_reference at every tiled site of
    the training path (batch 4, each with its activation and order), at the
    edge planes and at the regimes' edges with every activation and order,
    in bf16 and f32; a second launch must give the same bits. Then its
    autograd Function
    (kernel forward, the centered backward) against autograd of
    tiled_reference at a generator site."""
    err = 0.0
    cases = [(shape, act, order) for shape, act, order in TILED_SITES]
    cases += [(shape, act, order) for shape in TILED_EDGES for act in ACTS
              for order in ORDERS]
    for i, (shape, act, order) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(shape, 800 + i, dtype, 2.0) + 0.5
            got = in_act_tiled_cuda(x, act, order)
            label = f"in_act_tiled {shape} {str(dtype)[6:]} {act}/{order}"
            err = max(err, compare(label, got,
                                   tiled_reference(x, act, order)))
            require(torch.equal(in_act_tiled_cuda(x, act, order), got),
                    f"{label}: a second launch gave other bits")
    say(f"in_act_tiled: {2 * len(cases)} cases, each repeated bit for bit")
    err = max(err, check_in_edges("in_act_tiled", in_act_tiled_cuda,
                                  tiled_reference, 700))
    shape = TILED_SITES[1][0]
    for dtype in (torch.bfloat16, torch.float32):
        for act, order in (("relu", "act_norm"), ("leaky_relu", "norm_act")):
            x = randn(shape, 900, dtype, 2.0) + 0.5
            gy = randn(shape, 901, dtype)
            xa = x.clone().requires_grad_()
            y = instance_norm_act(xa, act=act, order=order, mode="tiled")
            (dx,) = torch.autograd.grad(y, xa, gy)
            xb = x.clone().requires_grad_()
            y_ref = tiled_reference(xb, act, order)
            (dx_ref,) = torch.autograd.grad(y_ref, xb, gy)
            label = f"tiled IN Function {shape} {str(dtype)[6:]} {act}/{order}"
            compare(f"{label} y", y, y_ref)
            compare(f"{label} dx", dx, dx_ref)
    return {"in_act_tiled": err}


def _task(dtype, device, name="cyclevaegan", instance_norm="auto",
          size=(IMAGE, LATENT, BASE)):
    task = create_task(name, model=ModelConfig(
        *size, dtype, instance_norm=instance_norm), device=device)
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
    _zero_counts()
    outs = []
    for seed, x in enumerate(requests):
        before = _counts()
        outs.append(run_inference(task, {"x": x}, seed=seed))
        per = tuple(a - b for a, b in zip(_counts(), before))
        require(per == (5, 0, 2, 0, 0),
                f"batch {x.shape[0]}: {per} launches of {KERNEL_NAMES}, "
                "expected 5 in_act and 2 starved_conv")
    _no_experiment_launches("slice")
    launches = {k: v for k, v in _launches().items() if v}
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
    return tuple(fn.launches for fn in WRAPPERS)


def _zero_counts() -> None:
    for fn in WRAPPERS + EXP_WRAPPERS:
        fn.launches = 0


def _no_experiment_launches(label: str) -> None:
    """The prototypes' kernels run on no model path."""
    stray = {n: fn.launches for n, fn in zip(EXP_NAMES, EXP_WRAPPERS)
             if fn.launches}
    require(not stray, f"{label}: prototype kernels launched: {stray}")


def _launches() -> dict:
    return dict(zip(KERNEL_NAMES, _counts()))


def _finite_metrics(metrics: dict) -> dict:
    vals = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
    require(all(np.isfinite(v) for v in vals.values()),
            f"finite metrics: {vals}")
    return vals


def train_path(name: str, instance_norm: str, want: tuple, steps: int,
               label: str) -> dict:
    """A training path: `steps` train_steps of the full-width bf16 task at
    batch 4, with every launch count set to 0 just before them and read just
    after; each step must launch `want` (WRAPPERS order), keep its losses
    finite and skip no update, and every parameter tensor must move. Then
    eval_step and generate."""
    task = _task(torch.bfloat16, DEV, name, instance_norm)
    batch = {"x": torch.as_tensor(_images(PATH_BATCH, 10), device=DEV),
             "y": torch.as_tensor(_images(PATH_BATCH, 11), device=DEV)}
    gen = torch.Generator(device=DEV).manual_seed(0)
    start = {n: p.detach().clone() for n, p in task.nets.named_parameters()}
    torch.cuda.synchronize()

    # the main path: the counts cover exactly these steps
    _zero_counts()
    for step in range(steps):
        before = _counts()
        vals = _finite_metrics(task.train_step(batch, generator=gen))
        per = tuple(a - b for a, b in zip(_counts(), before))
        require(per == want, f"{label} step {step}: {per} launches of "
                             f"{KERNEL_NAMES}, expected {want}")
        require(vals["nan_detected"] == 0.0,
                f"{label} step {step} skipped an update")
        losses = ", ".join(f"{k} {vals[k]:.4f}" for k in
                           ("G_loss", "D_loss", "loss_kl") if k in vals)
        say(f"train {label} step {step} (bf16, batch {PATH_BATCH}): "
            f"{losses}, nan_detected 0; launches {per} ok")
    launches = _launches()
    _no_experiment_launches(label)
    stuck = [n for n, p in task.nets.named_parameters()
             if torch.equal(p, start[n])]
    require(not stuck, f"{label}: parameters that did not move: {stuck}")
    say(f"train {label}: {steps} steps, launches {launches}; all "
        f"{len(start)} parameter tensors moved")
    metrics = task.eval_step(batch, generator=gen)
    _finite_metrics(metrics)
    images = {k: metrics[k] for k in ("Gx", "Fy") if k in metrics}
    require(set(images) == ({"Gx", "Fy"} if task.has_fy else {"Gx"}),
            f"{label} eval_step images {sorted(images)}")
    images["generate"] = task.generate({"x": batch["x"]}, generator=gen)
    for key, out in images.items():
        require(tuple(out.shape) == (PATH_BATCH, IMAGE, IMAGE, 3)
                and bool(torch.isfinite(out).all()),
                f"{label} {key} {tuple(out.shape)} finite")
    say(f"{label} eval_step: G_loss {float(metrics['G_loss']):.4f}; "
        f"{', '.join(images)} {(PATH_BATCH, IMAGE, IMAGE, 3)} finite")
    return {"task": task, "launches": launches}


def check_f32_step(name: str, instance_norm: str, size: tuple, batch: int,
                   label: str, beyond_share=None,
                   flipped_share=None) -> None:
    """One f32 train_step on the card (TF32 off) against the port's CPU step
    from the same weights, batch and noise: every metric within rtol
    STEP_METRIC_RTOL, the spectral vectors within STEP_SPECTRAL_ATOL, every
    parameter within one Adam step of the CPU's, and at most `beyond_share`
    of the elements further apart than rounding (1e-6) and `flipped_share`
    further apart than lr (moved the other way), where given."""
    image, latent, _ = size
    rng = np.random.RandomState(20)
    data = {"x": rng.rand(batch, image, image, 3).astype(np.float32),
            "y": rng.rand(batch, image, image, 3).astype(np.float32)}
    gpu = _task(torch.float32, DEV, name, instance_norm, size)
    cpu = _task(torch.float32, "cpu", name, instance_norm, size)
    eps = [rng.randn(batch, image // 16, image // 16, latent)
           .astype(np.float32) for _ in gpu.train_passes]
    got = _finite_metrics(gpu.train_step(data, eps=eps))
    t0 = time.perf_counter()
    want = _finite_metrics(cpu.train_step(data, eps=eps))
    cpu_s = time.perf_counter() - t0
    worst = max(abs(got[k] - want[k]) / (abs(want[k]) + 1e-3) for k in want)
    ok = set(got) == set(want) and all(
        abs(got[k] - want[k]) <= STEP_METRIC_RTOL * abs(want[k]) + 1e-5
        for k in want)
    say(f"check train_step f32 {label} card vs CPU (batch {batch}, TF32 "
        f"off, CPU step {cpu_s:.1f} s): metrics max relative error "
        f"{worst:.3e} (rtol {STEP_METRIC_RTOL:g}, atol 1e-5) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{label} train_step metrics card vs CPU: {got} vs {want}")
    lr = gpu.oc.lr
    gsd, csd = gpu.state_dict(), cpu.state_dict()
    spec, par, n, beyond_round, flipped = 0.0, 0.0, 0, 0, 0
    for key, c in csd.items():
        d = (gsd[key].cpu() - c).abs()
        if key.endswith(("weight_u", "weight_v")):
            spec = max(spec, float(d.max()))
            continue
        par = max(par, float(d.max()))
        n += d.numel()
        beyond_round += int((d > 1e-6).sum())
        flipped += int((d > lr).sum())
    say(f"check train_step f32 {label} card vs CPU: spectral u/v max_abs_err "
        f"{spec:.3e} (atol {STEP_SPECTRAL_ATOL:g}); parameters max_abs_err "
        f"{par:.3e} = {par / lr:.3f} lr (bound 2 lr + 1e-6); "
        f"{beyond_round / n:.4f} of {n} elements differ by more than 1e-6 "
        f"(bound {beyond_share}), {flipped / n:.4f} by more than lr "
        f"(opposite Adam signs; bound {flipped_share})")
    require(spec <= STEP_SPECTRAL_ATOL, f"{label} spectral vectors card vs CPU")
    require(par <= 2 * lr + 1e-6,
            f"{label} parameters card vs CPU within one Adam step")
    if beyond_share is not None:
        require(beyond_round / n <= beyond_share,
                f"{label} parameters card vs CPU: more than {beyond_share:g} "
                "of the elements differ beyond rounding")
    if flipped_share is not None:
        require(flipped / n <= flipped_share,
                f"{label} parameters card vs CPU: more than "
                f"{flipped_share:g} of the elements moved the other way")


# the hand kernels of the training path by the CUDA functions the profiler
# names (K3: starved_conv.cu, K4: starved_dw.cu, K1: in_act.cu and K2:
# in_act_tiled.cu, both in_plane.cuh's kernels, told apart by their variance
# formula), and the wrappers that launch them
HAND_KERNELS = {"K3": ("::conv_kernel<",),
                "K4": ("::dw_gemm_kernel<", "::dw_reduce_kernel("),
                "K1": ("plane_kernel<vct::Centered",),
                "K2": ("plane_kernel<vct::SinglePass",)}
HAND_WRAPPERS = {"K3": (reflect_conv_cuda, zero_conv_cuda), "K4": (dw_cuda,),
                 "K1": (in_act_cuda,), "K2": (in_act_tiled_cuda,)}


def hand_launches() -> dict:
    return {name: sum(w.launches for w in wrappers)
            for name, wrappers in HAND_WRAPPERS.items()}


def hand_kernel_ms(events, steps: int) -> dict:
    """Device time per step of each hand kernel in a profile of `steps`
    steps (kernels that did not run are left out)."""
    out = {}
    for name, keys in HAND_KERNELS.items():
        us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(key in e.key for key in keys))
        if us > 0:
            out[name] = us / 1e3 / steps
    return out


def time_steps(task, batches, label: str, card: str,
               profile_lines=0) -> dict:
    """Training step time per batch size: median of 5 train_steps after 2
    warm-ups (host clock around the step and a synchronize), peak device
    memory over them, then the device's busy time over 2 profiled steps and
    the idle share 1 - busy / median. The profile table goes to
    chiprun_out/profile_train_<label>_batch<b>.txt, its first
    `profile_lines` lines to the output."""
    times = {}
    gen = torch.Generator(device=DEV).manual_seed(1)
    for b in batches:
        batch = {"x": torch.as_tensor(_images(b, 40 + b), device=DEV),
                 "y": torch.as_tensor(_images(b, 41 + b), device=DEV)}
        for _ in range(2):
            task.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        with kernels.record_sites() as sites:
            for _ in range(5):
                t0 = time.perf_counter()
                vals = _finite_metrics(task.train_step(batch, generator=gen))
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                require(vals["nan_detected"] == 0.0,
                        f"{label}: timed step skipped")
        med = float(np.median(lat))
        # the IN kernels' byte bound per step, over the sites they took
        in_bound = {name: sum(in_act_bound(site[1], getattr(torch, site[2]))[
            "bound_ms"] for site in sites if site[0] == kind) / len(lat)
            for name, kind in (("K1", "in_act"), ("K2", "in_act_tiled"))}
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        before = hand_launches()
        busy, events = profiled(lambda: task.train_step(batch, generator=gen),
                                2)
        launched = [name for name, n in hand_launches().items()
                    if n > before[name]]
        idle = "not measured" if busy is None else \
            f"{max(0.0, 1 - busy / med):.3f}"
        times[b] = med
        say(f"time train_step {label} batch {b} bf16: median {med:.2f} ms of "
            f"{len(lat)} (min {min(lat):.2f}, max {max(lat):.2f}), "
            f"{b / med * 1e3:.1f} img/s, device busy {ms_text(busy, 2)} ms "
            f"per step (idle share {idle}), peak memory {peak:.0f} MiB "
            f"[{card}]")
        if busy is not None:
            # a kernel that launched must show in a profile that saw the
            # device at all, or HAND_KERNELS has lost its name
            per_kernel = hand_kernel_ms(events, 2)
            missing = [name for name in launched if name not in per_kernel]
            require(not missing, f"{label} batch {b}: {missing} launched in "
                    "the profiled steps but show no device time under the "
                    f"names {[HAND_KERNELS[m] for m in missing]}")
            shares = ", ".join(
                f"{name} {ms:.2f} ms ({ms / med:.3f} of the median"
                + (f"; bound {in_bound[name]:.3f} ms" if name in in_bound
                   else "") + ")"
                for name, ms in per_kernel.items())
            say(f"time train_step {label} batch {b}: device time per step by "
                f"hand kernel: {shares} [{card}]")
        table = events.table(sort_by="self_cuda_time_total", row_limit=45)
        OUT_DIR.mkdir(exist_ok=True)
        path = OUT_DIR / f"profile_train_{label}_batch{b}.txt"
        path.write_text(table)
        if profile_lines:
            say(f"profile (train_step {label}, batch {b}, 2 steps; top self "
                f"device time, full table in {path}):")
            for line in table.splitlines()[:profile_lines]:
                say(f"  {line}")
    return times


def phase_train_times(card: str, tr: dict) -> dict:
    b16 = torch.bfloat16
    times = {}

    def show(label, t, work):
        b = bound(*work, "bf16")
        say(f"time {label} bf16: kernel {t['ms']:.4f} ms (device "
            f"{ms_text(t['device_ms'])}), plain {t['plain_ms']:.4f} ms "
            f"(device {ms_text(t['plain_device_ms'])}), library "
            f"{ms_text(t['library_ms'])} ms, bound {b['bound_ms']:.5f} ms "
            f"({b['bound_by']}) [{card}]")

    # the training kernels at the path's shapes, batch 4. The library calls:
    # the zero-padded conv is one F.conv2d (the plain version itself); the
    # weight gradient is conv2d_weight on the reflect-padded bf16 input,
    # padded before the timed loop (it rounds dw to bf16, the kernel keeps
    # f32)
    dx_total = dw_total = None
    dx_work, dw_work = [], []
    for name, cin, cout, k in TRAIN_CONVS:
        x = randn((PATH_BATCH, cin, IMAGE, IMAGE), 30, b16)
        g = randn((PATH_BATCH, cout, IMAGE, IMAGE), 31, b16)
        wrot = rotate(randn((cout, cin, k, k), 32, b16, 0.05)).contiguous()
        t = kernel_vs_plain(lambda: zero_conv_cuda(g, wrot),
                            lambda: zero_conv(g, wrot),
                            lambda: F.conv2d(g, wrot, padding=k // 2), 10)
        dx_work.append(conv_work(g.shape, cin, k, (IMAGE, IMAGE), 2, 2))
        show(f"starved_conv zero_same {name} dx g{tuple(g.shape)} "
             f"wrot{tuple(wrot.shape)}", t, dx_work[-1])
        dx_total = add_times(dx_total, t)
        xp = reflect_pad(x, k // 2)
        t = kernel_vs_plain(
            lambda: dw_cuda(x, g, k), lambda: dw_reference(x, g, k),
            lambda: torch.nn.grad.conv2d_weight(xp, (cout, cin, k, k), g), 10)
        # x and g read once (bf16), dw written once (f32)
        _, ops = conv_work(x.shape, cout, k, (IMAGE, IMAGE), 2, 2)
        dw_work.append((2 * (x.numel() + g.numel()) + 4 * cout * cin * k * k,
                        ops))
        show(f"starved_conv_dw {name} x{tuple(x.shape)} g{tuple(g.shape)} "
             f"k{k}", t, dw_work[-1])
        dw_total = add_times(dw_total, t)
    times["starved_conv_zero_same"] = {**dx_total,
                                       **sum_bounds(dx_work, "bf16")}
    times["starved_conv_dw"] = {**dw_total, **sum_bounds(dw_work, "bf16")}
    times.update({("train", b): t for b, t in time_steps(
        tr["task"], TRAIN_BATCHES, "cyclevaegan", card, 20).items()})
    return times


def phase_times(card: str, sl: dict) -> dict:
    b16 = torch.bfloat16
    times = {}

    def show(label, t):
        say(f"time {label} bf16: kernel {t['ms']:.4f} ms (device "
            f"{ms_text(t['device_ms'])}), plain {t['plain_ms']:.4f} ms "
            f"(device {ms_text(t['plain_device_ms'])}), library "
            f"{ms_text(t['library_ms'])} ms [{card}]")

    # kernels at the path shapes (batch 4 and 16, bf16). IN+act at the R
    # blocks' identity site, where F.instance_norm is the library call; the
    # conv's library call is cuDNN's F.conv2d on the input reflect-padded
    # before the timed loop
    for b in (PATH_BATCH, 16):
        shape = (b,) + IDENTITY_SITE[1:]
        x = randn(shape, 7, b16)
        t = kernel_vs_plain(lambda: in_act_cuda(x, "identity", "act_norm"),
                            lambda: fused_reference(x, "identity", "act_norm"),
                            lambda: F.instance_norm(x), 200)
        times[("in_act", b)] = {**t, **in_act_bound(shape, b16)}
        show(f"in_act {shape} identity/act_norm", t)
        total, work = None, []
        for name, cin, cout, kk in (("U4", BASE // 2, BASE, 3),
                                    ("tail", BASE, 3, 7)):
            x = randn((b, cin, IMAGE, IMAGE), 8, b16)
            w = randn((cout, cin, kk, kk), 9, b16, 0.05)
            xp = reflect_pad(x, kk // 2)
            t = kernel_vs_plain(lambda: reflect_conv_cuda(x, w),
                                lambda: reflect_conv(x, w),
                                lambda: F.conv2d(xp, w), 20)
            show(f"starved_conv {name} x{tuple(x.shape)} w{tuple(w.shape)}", t)
            total = add_times(total, t)
            work.append(conv_work(x.shape, cout, kk, (IMAGE, IMAGE), 2, 2))
        times[("starved_conv", b)] = {**total, **sum_bounds(work, "bf16")}

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


def phase_in_times(card: str) -> dict:
    """The two IN kernels at the identity site against their plain versions
    and F.instance_norm (the summary line's numbers); then, at every tiled
    site of the training path at batch 4 and 24 (bf16; batch 24 puts the big
    planes beyond the 50 MB L2; each loop reads the same x, so the smaller
    ones stay in L2), K2 (every site), K1 (every site: its own path's are
    the slabs of at most 1 MB), tiled_reference, fused_reference and, at the
    identity sites, F.instance_norm side by side: CUDA events and device
    time per call (the kernels' per launch the profiler recorded), the
    kernels' host microseconds per call, and the byte bound."""
    b16 = torch.bfloat16
    x = randn(IDENTITY_SITE, 7, b16)
    t = kernel_vs_plain(lambda: in_act_tiled_cuda(x, "identity", "act_norm"),
                        lambda: tiled_reference(x, "identity", "act_norm"),
                        lambda: F.instance_norm(x), 200)
    say(f"time in_act_tiled {IDENTITY_SITE} identity/act_norm bf16: kernel "
        f"{t['ms']:.4f} ms (device {ms_text(t['device_ms'])}), plain "
        f"{t['plain_ms']:.4f} ms (device {ms_text(t['plain_device_ms'])}), "
        f"F.instance_norm {t['library_ms']:.4f} ms [{card}]")
    out = {"in_act_tiled": {**t, **in_act_bound(IDENTITY_SITE, b16)}}
    for b in TRAIN_BATCHES:
        for i, (site, act, order) in enumerate(TILED_SITES):
            shape = (b,) + site[1:]
            x = randn(shape, 950 + i, b16, 2.0) + 0.5
            fns = {"K2": lambda: in_act_tiled_cuda(x, act, order),
                   "K1": lambda: in_act_cuda(x, act, order),
                   "tiled_reference": lambda: tiled_reference(x, act, order),
                   "fused_reference": lambda: fused_reference(x, act, order)}
            if act == "identity":
                fns["F.instance_norm"] = lambda: F.instance_norm(x)
            iters = 50 if x.numel() < 2 ** 24 else 10
            ms = time_calls(fns, iters)
            host = {k: host_us(fns[k], iters) for k in ("K2", "K1")}
            dev = {k: kernel_device_ms(fns[k], iters, HAND_KERNELS[k])
                   for k in ("K2", "K1")}
            dev.update({k: profiled(fns[k], iters)[0] for k in fns
                        if k not in dev})
            b_ms = in_act_bound(shape, b16)["bound_ms"]
            mb = shape[1] * shape[2] * shape[3] * 4 / 2 ** 20
            path = "K1 and K2" if slab_fits(shape) else "K2"
            say(f"time IN site {shape} {act}/{order} bf16 ({path}'s path; "
                f"f32 slab {mb:g} MiB per sample; plan "
                f"{plane_plan(shape[2] * shape[3], b16)['regime']}), CUDA "
                "events / device per call: " + ", ".join(
                    f"{k} {v:.4f} / {ms_text(dev[k])} ms"
                    for k, v in ms.items())
                + f"; host per call K2 {host['K2']:.1f} us, K1 "
                f"{host['K1']:.1f} us; bound {b_ms:.5f} ms (bytes) [{card}]")
            del x
    return out


def phase_tiled_train(card: str) -> dict:
    """The cyclevaegan step under instance_norm="tiled": the path, the f32
    step against the CPU's, and the step times at batch 4 and 24."""
    tr = train_path("cyclevaegan", "tiled", TILED_STEP_LAUNCHES, 3,
                    "cyclevaegan-tiled")
    check_f32_step("cyclevaegan", "tiled", (IMAGE, LATENT, BASE), 1,
                   "cyclevaegan-tiled", beyond_share=STEP_PARAM_SHARE)
    time_steps(tr["task"], TRAIN_BATCHES, "cyclevaegan-tiled", card, 20)
    return tr["launches"]


def phase_families(card: str) -> None:
    """The nine other architectures: the training path at full width (two
    bf16 train_steps at batch 4, then eval_step and generate), five timed
    steps after those two, and one f32 step on the card against the CPU's at
    FAMILY_F32_SIZE."""
    for name in ARCHITECTURES:
        if name == "cyclevaegan":
            continue
        tr = train_path(name, "auto", FAMILY_STEP_LAUNCHES[name], 2, name)
        time_steps(tr["task"], (PATH_BATCH,), name, card)
        del tr
        torch.cuda.empty_cache()
        check_f32_step(name, "auto", FAMILY_F32_SIZE, 2, name,
                       flipped_share=FAMILY_FLIPPED[name])


def phase_experiment_kernels() -> dict:
    """K5-K8 against their plain versions on the card: the three conv
    kernels at their prototypes' shapes (batch 24, bf16) and at EXP_EDGES
    (bf16 and f32), K8 at the six probes (bf16) and PROBE_EDGES (bf16 and
    f32) on all-ones operands (exact) and random ones (rtol 1e-5, with an
    atol of 1e-5 of the largest element for the sums near zero). Every
    kernel gives the same bits on a second launch; the conv wrappers refuse
    an R that does not divide h."""
    b16, f32 = torch.bfloat16, torch.float32
    errs = dict.fromkeys(EXP_NAMES, 0.0)
    for name, module, kernel, plain, _ in EXP_CONVS:
        cases = [(EXP_BATCH, s, s, cin, cout, k, R, b16)
                 for _, s, cin, cout, k, R in module.SHAPES]
        cases += [(2, h, w, cin, cout, k, R, dtype)
                  for h, w, cin, cout, k, R in EXP_EDGES
                  for dtype in (b16, f32)]
        for i, (n, h, w, cin, cout, k, R, dtype) in enumerate(cases):
            x = dev_randn((n, h, w, cin), 1000 + i, dtype)
            wgt = dev_randn((k, k, cin, cout), 1100 + i, dtype, 0.05)
            label = (f"{name} x{(n, h, w, cin)} w{(k, k, cin, cout)} R{R} "
                     f"{str(dtype)[6:]}")
            got = kernel(x, wgt, R)
            errs[name] = max(errs[name], compare(label, got, plain(x, wgt)))
            require(torch.equal(kernel(x, wgt, R), got),
                    f"{label}: a second launch gave other bits")
            del x, wgt, got
        x = randn((2, 16, 20, 3), 1200, f32)
        wgt = randn((7, 7, 3, 8), 1201, f32)
        try:
            kernel(x, wgt, 5)
        except ValueError as exc:
            say(f"{name}: R=5 with h=16 refused ({exc})")
        else:
            raise RuntimeError(f"check failed: {name} took R=5 with h=16")
        say(f"{name}: {len(cases)} cases, each repeated bit for bit")
    probes = [(mk, nk, kk, steps, b16)
              for _, mk, nk, kk, steps in dw_dot_probe.SHAPES]
    probes += [edge + (dtype,) for edge in PROBE_EDGES for dtype in (b16, f32)]
    for i, (mk, nk, kk, steps, dtype) in enumerate(probes):
        for ones in (True, False):
            label = (f"dot_probe p{(mk, kk)} g{(nk, kk)} x{steps} "
                     f"{str(dtype)[6:]} {'ones' if ones else 'random'}")
            if ones:
                p = torch.ones((mk, kk), dtype=dtype, device=DEV)
                g = torch.ones((nk, kk), dtype=dtype, device=DEV)
            else:
                p = dev_randn((mk, kk), 1300 + i, dtype)
                g = dev_randn((nk, kk), 1400 + i, dtype)
            got = dw_dot_probe.dot_probe_cuda(p, g, steps)
            want = dw_dot_probe.dot_probe_reference(p, g, steps)
            if ones:
                require(torch.equal(got, want), f"{label}: not exact")
                say(f"check {label}: exact ok")
            else:
                err = compare(label, got, want,
                              tol=(1e-5 * float(want.abs().max()), 1e-5))
                errs["dot_probe"] = max(errs["dot_probe"], err)
            require(torch.equal(dw_dot_probe.dot_probe_cuda(p, g, steps), got),
                    f"{label}: a second launch gave other bits")
    say(f"dot_probe: {2 * len(probes)} cases, each repeated bit for bit")
    return errs


def phase_experiments(card: str) -> dict:
    """The prototypes' path: each entry point's ``main`` at its default
    batch (24) on the card, with every launch count set to 0 just before it
    and read just after; its kernel's count must equal the calls it
    reports, every other count 0. Then each kernel, its plain version and
    the library call timed at the prototypes' shapes: cuDNN's conv on the
    input padded before the timed loop (channels-last memory for the NHWC
    functions, NCHW for the channel-major one) and, for K8, `steps` calls
    of torch.mm (which rounds each product to bf16)."""
    mains = (conv_proto.main, lowcin_conv2.main, lowcin_conv3.main,
             dw_dot_probe.main)
    launches = {}
    for name, main_fn, wrapper in zip(EXP_NAMES, mains, EXP_WRAPPERS):
        torch.cuda.synchronize()
        _zero_counts()
        results = main_fn([])
        torch.cuda.synchronize()
        counts = dict(zip(EXP_NAMES, (fn.launches for fn in EXP_WRAPPERS)))
        calls = sum(r["calls"] for r in results)
        require(counts[name] == calls > 0, f"{name} main: {calls} calls, "
                f"{counts[name]} launches")
        require(not any(_counts()) and not any(
            v for n, v in counts.items() if n != name),
            f"{name} main: other kernels launched: {counts}, {_launches()}")
        for r in results:
            err = r.get("err", r.get("relerr"))
            require(np.isfinite(err) and r["ms"] is not None,
                    f"{name} main {r['name']}: err {err}, ms {r['ms']}")
        launches[name] = counts[name]
        say(f"experiments: {name} main at batch {EXP_BATCH}: "
            f"{len(results)} shapes, {calls} calls = {counts[name]} "
            "launches ok")

    b16 = torch.bfloat16
    times = {}

    def show(label, t, alone):
        say(f"time {label} bf16: kernel {t['ms']:.4f} ms (device "
            f"{ms_text(t['device_ms'])}, of it the kernel alone "
            f"{ms_text(alone)}), plain {t['plain_ms']:.4f} ms (device "
            f"{ms_text(t['plain_device_ms'])}), library "
            f"{ms_text(t['library_ms'])} ms [{card}]")

    for name, module, kernel, plain, _ in EXP_CONVS:
        total, work = None, []
        for label, s, cin, cout, k, R in module.SHAPES:
            x, w = conv_operands(EXP_BATCH, s, cin, cout, k, DEV, b16)
            memory = (torch.contiguous_format if name == "lowcin_conv_cm"
                      else torch.channels_last)
            xp = reflect_pad(x.permute(0, 3, 1, 2), k // 2).contiguous(
                memory_format=memory)
            wl = w.permute(3, 2, 0, 1).contiguous(memory_format=memory)
            t = kernel_vs_plain(lambda: kernel(x, w, R), lambda: plain(x, w),
                                lambda: F.conv2d(xp, wl), 5)
            show(f"{name} {label} x{tuple(x.shape)} R{R}", t,
                 kernel_device_ms(lambda: kernel(x, w, R), 5,
                                  (EXP_KERNEL_NAMES[name],)))
            total = add_times(total, t)
            work.append(conv_work((EXP_BATCH, cin, s, s), cout, k, (s, s),
                                  2, 2))
            del x, w, xp, wl
        times[name] = {**total, **sum_bounds(work, "bf16")}
    total, work = None, []
    for label, mk, nk, kk, steps in dw_dot_probe.SHAPES:
        p = torch.ones((mk, kk), dtype=b16, device=DEV)
        g = torch.ones((nk, kk), dtype=b16, device=DEV)
        gt = g.T
        t = kernel_vs_plain(
            lambda: dw_dot_probe.dot_probe_cuda(p, g, steps),
            lambda: dw_dot_probe.dot_probe_reference(p, g, steps),
            lambda: [torch.mm(p, gt) for _ in range(steps)], 3)
        show(f"dot_probe {label} x{steps}", t, t["device_ms"])
        total = add_times(total, t)
        work.append((2 * (mk + nk) * kk + 4 * mk * nk,
                     2.0 * mk * nk * kk * steps))
    times["dot_probe"] = {**total, **sum_bounds(work, "bf16")}
    return {"launches": launches, "times": times}


def main() -> None:
    card = phase_card()
    phase_build()
    errs = phase_kernels()
    errs.update(phase_train_kernels())
    errs.update(phase_tiled_kernels())
    sl = phase_slice()
    times = phase_times(card, sl)
    del sl
    tr = train_path("cyclevaegan", "auto", STEP_LAUNCHES, 3, "cyclevaegan")
    check_f32_step("cyclevaegan", "auto", (IMAGE, LATENT, BASE), 1,
                   "cyclevaegan", beyond_share=STEP_PARAM_SHARE)
    times.update(phase_train_times(card, tr))
    launches = tr["launches"]  # the training path's three steps
    del tr
    torch.cuda.empty_cache()
    tiled_launches = phase_tiled_train(card)
    torch.cuda.empty_cache()
    times.update(phase_in_times(card))
    phase_families(card)
    torch.cuda.empty_cache()
    errs.update(phase_experiment_kernels())
    exp = phase_experiments(card)
    conv_src = "vae_cyclegan_tpu_torch/csrc/starved_conv.cu"
    lowcin_src = "vae_cyclegan_tpu_torch/csrc/lowcin_conv.cu"
    sources = {"conv_proto": "vae_cyclegan_tpu_torch/csrc/conv_proto.cu",
               "lowcin_conv_cm": lowcin_src, "lowcin_conv_nhwc": lowcin_src,
               "dot_probe": "vae_cyclegan_tpu_torch/csrc/dot_probe.cu"}
    replaces = {name: tpu for name, *_, tpu in EXP_CONVS}
    replaces["dot_probe"] = "experiments/dw_dot_probe.py:25"
    summary = {"kernels": [
        {"name": "in_act", "route": "cuda",
         "source": "vae_cyclegan_tpu_torch/csrc/in_act.cu",
         "replaces": "vae_cyclegan_tpu/ops/instance_norm.py:110",
         "launches": launches["in_act"],
         "max_abs_err": errs["in_act"],
         # the identity site at batch 4
         **measured(times[("in_act", PATH_BATCH)])},
        {"name": "in_act_tiled", "route": "cuda",
         "source": "vae_cyclegan_tpu_torch/csrc/in_act_tiled.cu",
         "replaces": "vae_cyclegan_tpu/ops/instance_norm.py:180",
         # the tiled training path's three steps
         "launches": tiled_launches["in_act_tiled"],
         "max_abs_err": errs["in_act_tiled"],
         # the identity site at batch 4
         **measured(times["in_act_tiled"])},
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
    ] + [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name],
         # the entry point's run at batch 24
         "launches": exp["launches"][name],
         "max_abs_err": errs[name],
         # summed over the prototype's shapes at batch 24 (K8: its probes)
         **measured(exp["times"][name])}
        for name in EXP_NAMES]}
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
