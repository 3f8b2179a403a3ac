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
              (batch 24, bf16) and at edge shapes (f32 and bf16; K6 and K7
              also at planes of k / 2 + 1), bit for bit on a second launch,
              R not dividing h refused; then each prototype's entry point
              (``main``) at its default batch, 24, whose calls must equal
              its kernel's launches; kernel, plain version and library call
              timed at the prototypes' shapes, each conv shape beside its
              bound and the kernel's factor over it; K8's launch plan per
              probe (tile, cluster, CTAs, waves, the clusters the card
              places at once) and its device time per probe and summed (in
              a child process, ``chip_smoke.py --k8-device``, where this one
              kept no record); K8 and `steps` x torch.mm in five
              alternating turns (min / median / max)
  9. times:   kernel vs plain vs the library call (CUDA events), each
              kernel's bound (bytes over HBM bandwidth or operations over
              the peak rate, whichever is larger), the two IN kernels and
              the plain versions at every tiled site at batch 4 and 24
              (events, device time, the wrappers' host time per call, the
              byte bound; F.instance_norm at the identity sites), request
              latency per
              batch size and training step time at batch 4 and 24 (host
              clock, median), device busy time and idle share, peak device
              memory, profiler summaries (device times count the launches
              the profiler recorded; one it did not record in three
              sessions, or above 1.1x its CUDA-event time, is printed as
              not measured and left out of the summary; the CUDA-event
              times are always taken),
              and per training step each hand kernel's device time (a
              kernel that launched must show in a profile that saw the
              device), with the IN kernels' byte bound per step
 10. data and engine: a synthetic Hypersim tree of 768x1024 frames and its
              decoded-image cache (whether the native C++ data plane built,
              and why not); Engine.train_epoch of the unpaired bf16
              cyclevaegan task at batch 4 over three loader batches on the
              uint8 wire (host crops) and on the raw wire (device_aug on the
              card), each epoch's launches the unpaired step's times the
              batches, its metrics finite, no skipped update, then
              validate; device_augment on the card against the port's CPU
              device_augment on a raw batch; and ``python -m
              vae_cyclegan_tpu_torch.bench`` at its defaults (its step
              through a world-1 NCCL group, ``BENCH_UNIFIED``) without the
              loader-only phase, in a child process: no error key, a
              positive step and e2e rate over an epoch of several batches,
              the unpaired step's launches per step; its JSON line and the
              phase's wall time
 11. drivers: the port's entry points in process on a synthetic tree of
              768x1024 frames and its decoded-image cache (built by
              ``data.tools cache``): ``train`` (full-width bf16
              cyclevaegan, unpaired, batch 4, 2 epochs of 3 batches, one
              validation batch, a checkpoint each epoch), each training
              epoch the unpaired step's launches times its steps and no
              prototype kernel; the run directory and train.py's
              TensorBoard tags; checkpoint_epoch_2 loaded into a fresh task
              and engine on the card bit for bit (weights, both Adam states,
              the generator), its save and load times; a NaN batch skipped
              with one dump of the expected keys; ``--resume`` from
              checkpoint_epoch_1 (epoch 2, Adam's step carried on, the
              TensorBoard events past epoch 1 truncated); doubleae then
              cycleae ``--pretrained_doubleae`` (G's and F's encoders the
              Double encoder's before the first step, no shared storage);
              ``test`` over the run (summary.json's metrics finite; the
              figures where the machine has matplotlib); InceptionV3 on
              the card against the CPU and fid_score; images/s of the
              training epochs and of ``test`` (logs in
              chiprun_out/drivers.log)
 12. export, remat, trajectories: the full-width bf16 cyclevaegan
              generator exported with a symbolic batch
              (``utils.export``), saved and loaded: its graph holds 5
              vct::in_act and 2 vct::starved_conv nodes, at batch 1 and 4
              it launches K1 and K3 as generate does and its output equals
              generate's (bit for bit, else within the bf16 tolerance),
              latencies at 1, 4 and 16 beside generate's, export / save /
              load seconds; batch-24 steps with and without remat
              (``ModelConfig.remat``): one step's metrics on the same noise
              (bit for bit, else within rtol 2e-3), launches per step (the
              recompute adds 5 K1 and 2 K3 per generator pass), step time
              and peak memory, remat's below the other's; 10 steps of the
              paired batch-4 task in bf16, f32 and four one-ulp twins of
              f32 (``python -m vae_cyclegan_tpu_torch.parity_curves``), the
              bf16 trajectory's mean G_loss and D_loss within max(2%, 2x the
              largest twin's gap) of f32's, every value finite; the same for the tiled configuration (K2); the
              host microseconds per call of the K1 / K3 / K4 sites through
              the custom operators (``host_cost``)
 13. data parallelism: a world-1 NCCL group (``parallel.mesh``); the
              full-width bf16 paired cyclevaegan at batch 24 through
              ``Engine(task, seed, group)``: its first step's synced
              gradients (both optimizers) and metrics bit for bit the
              local ones, its launches those of the plain step (46 / 0 /
              12 / 14 / 18), its metrics within the range of three plain
              runs from the same state widened by their largest pairwise
              gap, its parameters within one Adam step; step medians (5
              after 2 warm-ups) in turns plain, world 1, world 1, plain,
              each with its peak memory, and the sync's time per step
              (CUDA events); then two spawned gloo ranks on the one card
              (2 samples each, one step): their metrics the mean of this
              process's plain step on each rank's samples (rtol 2e-3),
              their parameters within one Adam step of the world-1 step on
              all 4, the ranks bit for bit equal

Each main path (the serving requests, each training run) is driven with
every launch count set to 0 just before it and read just after it. Any
failed check raises, and the script exits non-zero without printing its last
line, ``{"ok": true, "device": {...}}``. The line before it names the card,
and the one before that is the ``{"kernels": [...]}`` summary.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vae_cyclegan_tpu_torch import bench, host_cost, kernels, parity_curves
from vae_cyclegan_tpu_torch import test as test_driver
from vae_cyclegan_tpu_torch import train as train_driver
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.data import (
    AugmentConfig,
    DataLoader,
    DecodedImageCache,
    HypersimDataset,
    native,
)
from vae_cyclegan_tpu_torch.data import datasets as data_datasets
from vae_cyclegan_tpu_torch.data import tools as data_tools
from vae_cyclegan_tpu_torch.data.device_aug import device_augment
from vae_cyclegan_tpu_torch.engine import Engine
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
from vae_cyclegan_tpu_torch.host_cost import host_us
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
from vae_cyclegan_tpu_torch.parallel import dp, mesh
from vae_cyclegan_tpu_torch.ops.starved_conv import (
    dw_cuda,
    dw_reference,
    reflect_conv_cuda,
    rotate,
    starved_reflect_conv,
    zero_conv,
    zero_conv_cuda,
)
from vae_cyclegan_tpu_torch.utils import (
    fid,
    load_checkpoint,
    nan_dump,
    save_checkpoint,
)
from vae_cyclegan_tpu_torch.utils import export as export_mod

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
EXP_KERNEL_NAMES = {"conv_proto": "conv_proto_nhwc_kernel",
                    "lowcin_conv_cm": "lowcin_cm_kernel",
                    "lowcin_conv_nhwc": "lowcin_nhwc_kernel",
                    "dot_probe": "dot_probe_cluster_kernel"}
EXP_BATCH = 24   # the prototypes' batch
# edge shapes (h, w, cin, cout, k, R), tests/test_torch_kernels.py's
# PROTO_CASES: k = 7, 5, 3; cin = 3, 5 (the NHWC core's register-staged
# loader), 8, 32, 64 (its cp.async one); widths off the multiple of 8 and
# ragged column tiles; two R per shape; cout 3, 6, 8 folded, 6 and 8 at k 7
# and 16 narrow, 80 and 128 the 128-wide tile; 256 x 256 more tiles than a
# block's slab ring holds; for K6's flat loader w + 2p a multiple of 8 (no
# zero columns) and not, and h that the card's bands do not divide (the last
# band's slab past the zero row the wrap columns read, and past the image)
EXP_EDGES = [(16, 20, 3, 8, 7, 8), (16, 20, 3, 8, 7, 16), (24, 30, 5, 6, 5, 8),
             (24, 30, 5, 6, 5, 12), (32, 36, 8, 16, 3, 16),
             (32, 36, 8, 16, 3, 4), (16, 24, 64, 3, 7, 8),
             (32, 32, 32, 64, 3, 16), (8, 130, 64, 128, 3, 8),
             (6, 300, 64, 80, 3, 6), (10, 36, 32, 3, 3, 10),
             (8, 20, 8, 6, 7, 8), (12, 20, 5, 8, 3, 4), (256, 256, 8, 64, 3, 16),
             (4, 26, 8, 16, 7, 4), (6, 30, 64, 3, 3, 3), (5, 18, 64, 3, 7, 5),
             (3, 13, 5, 8, 5, 1), (7, 9, 3, 64, 7, 7), (9, 10, 32, 128, 3, 9)]
# K7 and K6 (K7's loader reflects; K6's rows are mostly wrap columns):
# planes of k / 2 + 1, REFLECT_EDGES there
EXP_REFLECT_EDGES = [(2, 2, 5, 8, 3, 2), (3, 3, 8, 64, 5, 3),
                     (4, 4, 3, 80, 7, 4), (4, 4, 32, 3, 7, 2),
                     (2, 2, 64, 16, 3, 1)]
# K8's edges (mk, nk, kk, steps), tests/test_torch_kernels.py's PROBE_CASES
# below the probes' shapes: ragged M, N and K; kk below one 16-slice per
# rank (8, 40: the plan shrinks the cluster); kk = 1, 7 and 15 mod 16 (97,
# 135, 303: the 2-byte loader); one step
PROBE_EDGES = [(24, 40, 100, 3), (40, 24, 77, 2), (24, 40, 8, 3),
               (40, 24, 40, 2), (24, 40, 97, 2), (40, 24, 135, 3),
               (33, 70, 303, 2), (24, 40, 100, 1)]
STEP_METRIC_RTOL = 2e-3
# the data and engine phase: loader batches per epoch (at PATH_BATCH), the
# unpaired cyclevaegan step's launches in WRAPPERS order (bench.py's step;
# tests/test_torch_bench.py holds bench.UNPAIRED_STEP_LAUNCHES to its kernel
# sites), device_augment on the card against the CPU's (f32 products in
# another order: allclose atol), and the bench child's time limit
DATA_BATCHES = 3
UNPAIRED_STEP_LAUNCHES = tuple(bench.UNPAIRED_STEP_LAUNCHES.get(n, 0)
                               for n in KERNEL_NAMES)
AUG_TOL = (1e-4, 0.0)
BENCH_TIMEOUT = 600
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
# Late in a long run a profiler session loses device records (in one run:
# 10 calls kept 9, 5 kept 2 or 3, 200 kept 195, and 3 long K8 calls mostly
# none) or keeps one longer than its call took, though a fresh process keeps
# them all; a pause or trailing kernels in the session did not help. So the
# device times count only what was recorded (launch_device_ms,
# kernel_device_ms) and kernel_vs_plain drops a wrapper's device time that
# exceeds its CUDA-event time by more than DEVICE_SLACK.
DEVICE_SLACK = 1.1


def profile_session(fn, iters: int):
    """`iters` calls of `fn` under torch.profiler; the profile."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof


def device_kernels(events):
    """The CUDA kernels of `events`."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_us(events, keys=None) -> tuple:
    """(summed self device time in us, launches) of the CUDA kernels in
    `events` whose profiler names hold one of `keys` (all of them without
    keys)."""
    hits = [e for e in device_kernels(events)
            if keys is None or any(key in e.key for key in keys)]
    return (sum(e.self_device_time_total for e in hits),
            sum(e.count for e in hits))


def profiled(fn, iters: int):
    """Runs `fn` `iters` times under torch.profiler. Returns the summed
    duration of the GPU kernels it launched, per call (what the device
    spends, without the host's launch gaps), and the key averages. A session
    that records no device activity at all (CUPTI now and then hands back an
    empty buffer; the timings from CUDA events are unaffected) is run again,
    up to PROFILE_TRIES times; after that the device time is None: not
    measured."""
    for _ in range(PROFILE_TRIES):
        events = profile_session(fn, iters).key_averages()
        us = device_us(events)[0]
        if us > 0:
            return us / 1e3 / iters, events
        say(f"profiler: a session over {iters} calls saw no device time")
    return None, events


def launch_device_ms(fn, iters: int, key: str):
    """The device time per call of `fn`, a wrapper whose every call launches
    the kernel whose profiler name holds `key` last: the device time of the
    session's kernels up to its last recorded `key` launch, over the `key`
    launches recorded. Late in a long run a session loses the device
    records of its last launches (10 calls kept 9, 5 kept 2 or 3, 3 long K8
    calls at times none), so the session's time over the calls made would
    undercount; over the whole calls recorded it does not. None where no
    session of PROFILE_TRIES recorded a launch of `key`: not measured."""
    for _ in range(PROFILE_TRIES):
        kernels = sorted(device_kernels(profile_session(fn, iters).events()),
                         key=lambda e: e.time_range.start)
        ends = [i for i, e in enumerate(kernels) if key in e.key]
        if len(ends) < iters:
            say(f"profiler: a session over {iters} calls recorded "
                f"{len(ends)} of their {iters} {key} launches")
        if ends:
            us = sum(e.time_range.elapsed_us() for e in kernels[:ends[-1] + 1])
            return us / 1e3 / len(ends)
    return None


def kernel_device_ms(fn, iters: int, keys):
    """The device time per launch of the CUDA kernels whose profiler names
    hold one of `keys` (a kernel alone, without its wrapper's other work),
    over `iters` calls of `fn` under the profiler: the median of the
    launches it recorded (a session can record fewer launches than were
    made, so dividing by the calls would undercount, and one run's summed
    time of a kernel fell far below its other runs'); a session that
    recorded none is run again, up to PROFILE_TRIES times; None after."""
    for _ in range(PROFILE_TRIES):
        us = sorted(e.time_range.elapsed_us()
                    for e in device_kernels(profile_session(fn, iters).events())
                    if any(key in e.key for key in keys))
        if us:
            return us[len(us) // 2] / 1e3
    return None


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


def kernel_vs_plain(kernel_fn, plain_fn, library_fn, iters: int,
                    key: str) -> dict:
    """time_calls of the plain version, the kernel and the library call that
    computes the same function; then the device times of the kernel's
    wrapper (per recorded launch of its kernel, named by `key`:
    launch_device_ms) and of the plain version, where the profiler saw
    them."""
    t = time_calls({"plain_ms": plain_fn, "ms": kernel_fn,
                    "library_ms": library_fn}, iters)
    t["device_ms"] = launch_device_ms(kernel_fn, iters, key)
    if t["device_ms"] is not None and t["device_ms"] > DEVICE_SLACK * t["ms"]:
        say(f"profiler: a {key} call's device time {t['device_ms']:.4f} ms "
            f"exceeds its CUDA-event time {t['ms']:.4f} ms: not measured")
        t["device_ms"] = None
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
                            lambda: F.conv2d(g, wrot, padding=k // 2), 10,
                            HAND_KERNELS["K3"][0])
        dx_work.append(conv_work(g.shape, cin, k, (IMAGE, IMAGE), 2, 2))
        show(f"starved_conv zero_same {name} dx g{tuple(g.shape)} "
             f"wrot{tuple(wrot.shape)}", t, dx_work[-1])
        dx_total = add_times(dx_total, t)
        xp = reflect_pad(x, k // 2)
        t = kernel_vs_plain(
            lambda: dw_cuda(x, g, k), lambda: dw_reference(x, g, k),
            lambda: torch.nn.grad.conv2d_weight(xp, (cout, cin, k, k), g), 10,
            HAND_KERNELS["K4"][1])  # its reduce, the last launch of a call
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
                            lambda: F.instance_norm(x), 200,
                            HAND_KERNELS["K1"][0])
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
                                lambda: F.conv2d(xp, w), 20,
                                HAND_KERNELS["K3"][0])
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
                        lambda: F.instance_norm(x), 200,
                        HAND_KERNELS["K2"][0])
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
        edges = EXP_EDGES + (EXP_REFLECT_EDGES
                             if name in ("lowcin_conv_nhwc", "lowcin_conv_cm")
                             else [])
        cases += [(2, h, w, cin, cout, k, R, dtype)
                  for h, w, cin, cout, k, R in edges
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

    def show(label, t, alone, b=None):
        factor = ""
        if b is not None:
            factor = (f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
                      f"events {t['ms'] / b['bound_ms']:.1f}x it, alone "
                      + ("not measured" if alone is None
                         else f"{alone / b['bound_ms']:.1f}x it"))
        say(f"time {label} bf16: kernel {t['ms']:.4f} ms (device "
            f"{ms_text(t['device_ms'])}, of it the kernel alone "
            f"{ms_text(alone)}), plain {t['plain_ms']:.4f} ms (device "
            f"{ms_text(t['plain_device_ms'])}), library "
            f"{ms_text(t['library_ms'])} ms{factor} [{card}]")

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
                                lambda: F.conv2d(xp, wl), 5,
                                EXP_KERNEL_NAMES[name])
            # K6's function writes every one of its Wp columns
            out_w = (lowcin_conv2.geometry(s, cin, k)[2]
                     if name == "lowcin_conv_cm" else s)
            work.append(conv_work((EXP_BATCH, cin, s, s), cout, k,
                                  (s, out_w), 2, 2))
            show(f"{name} {label} x{tuple(x.shape)} R{R}", t,
                 kernel_device_ms(lambda: kernel(x, w, R), 5,
                                  (EXP_KERNEL_NAMES[name],)),
                 sum_bounds(work[-1:], "bf16"))
            total = add_times(total, t)
            del x, w, xp, wl
        times[name] = {**total, **sum_bounds(work, "bf16")}
    total, work, probe_times = None, [], []
    for label, mk, nk, kk, steps in dw_dot_probe.SHAPES:
        p = torch.ones((mk, kk), dtype=b16, device=DEV)
        g = torch.ones((nk, kk), dtype=b16, device=DEV)
        gt = g.T
        t = kernel_vs_plain(
            lambda: dw_dot_probe.dot_probe_cuda(p, g, steps),
            lambda: dw_dot_probe.dot_probe_reference(p, g, steps),
            lambda: [torch.mm(p, gt) for _ in range(steps)], 3,
            EXP_KERNEL_NAMES["dot_probe"])
        work.append((2 * (mk + nk) * kk + 4 * mk * nk,
                     2.0 * mk * nk * kk * steps))
        pl = dw_dot_probe.plan(mk, nk, kk, b16)
        smem, fit = dw_dot_probe.resident(pl, kk, b16)
        require(smem == pl.smem, f"dot_probe {label}: the library's "
                f"{smem} shared bytes, the plan's {pl.smem}")
        say(f"plan dot_probe {label}: tile 32x{pl.tn}, cluster {pl.cluster}, "
            f"K slice {pl.kslice}, {pl.ctas} CTAs of {pl.smem} B, "
            f"{dw_dot_probe.waves(pl)} wave(s) by count; the card places "
            f"{fit} clusters of {pl.tiles} at once")
        # the wrapper launches nothing but its kernel
        show(f"dot_probe {label} x{steps}", t, t["device_ms"],
             sum_bounds(work[-1:], "bf16"))
        total = add_times(total, t)
        probe_times.append(t)
    times["dot_probe"] = {**total, **sum_bounds(work, "bf16")}
    probe_device(card, probe_times, times["dot_probe"])
    probe_turns(card)
    return {"launches": launches, "times": times}


PROBE_TURNS = 5


def probe_device_ms() -> list:
    """K8's device time per probe: launch_device_ms of 3 calls (None where
    the profiler kept no record of its launches)."""
    b16, out = torch.bfloat16, []
    for _, mk, nk, kk, steps in dw_dot_probe.SHAPES:
        p = torch.ones((mk, kk), dtype=b16, device=DEV)
        g = torch.ones((nk, kk), dtype=b16, device=DEV)
        fn = functools.partial(dw_dot_probe.dot_probe_cuda, p, g, steps)
        fn()
        torch.cuda.synchronize()
        out.append(launch_device_ms(fn, 3, EXP_KERNEL_NAMES["dot_probe"]))
    return out


def probe_device(card: str, probe_times: list, total: dict) -> None:
    """K8's profiler device time per probe and summed. Late in this run the
    profiler may keep no record of a probe's launches (ROADMAP R2); a fresh
    process keeps them, so where one is missing the six are profiled again
    in a child process (``chip_smoke.py --k8-device``). The sum goes into
    the kernels line where every probe has one; else it stays not
    measured."""
    dev = [t["device_ms"] for t in probe_times]
    where = "this process"
    if None in dev:
        where = (f"a child process for {dev.count(None)} of the six, where "
                 "this one kept no record")
        run = subprocess.run([sys.executable, __file__, "--k8-device"],
                             capture_output=True, text=True, timeout=600)
        lines = run.stdout.strip().splitlines()
        child = json.loads(lines[-1]) if run.returncode == 0 and lines else []
        if len(child) == len(dev):
            dev = [a if a is not None else b for a, b in zip(dev, child)]
        else:
            say(f"profiler: the child process gave no K8 device times "
                f"(exit {run.returncode}): {run.stderr.strip()[-300:]}")
    for (label, *_), ms in zip(dw_dot_probe.SHAPES, dev):
        say(f"time dot_probe {label}: device ms {ms_text(ms)} [{card}]")
    summed = None if None in dev else sum(dev)
    total["device_ms"] = summed
    say(f"time dot_probe over the six probes: events {total['ms']:.4f} ms, "
        f"device ms {ms_text(summed)} (from {where}), bound "
        f"{total['bound_ms']:.4f} ms [{card}]")


def probe_turns(card: str) -> None:
    """K8 against `steps` x torch.mm, summed over the six probes (CUDA events,
    3 calls a probe), in PROBE_TURNS turns that alternate which side goes
    first; each side's min, median and max. The library's figure moved 53%
    between two runs on one card model, so the two are compared only
    within a run, turn by turn."""
    b16 = torch.bfloat16
    sides = {"dot_probe": [], "torch.mm": []}
    fns = {"dot_probe": [], "torch.mm": []}
    for _, mk, nk, kk, steps in dw_dot_probe.SHAPES:
        p = torch.ones((mk, kk), dtype=b16, device=DEV)
        g = torch.ones((nk, kk), dtype=b16, device=DEV)
        fns["dot_probe"].append(
            lambda p=p, g=g, steps=steps: dw_dot_probe.dot_probe_cuda(
                p, g, steps))
        fns["torch.mm"].append(
            lambda p=p, gt=g.T, steps=steps: [torch.mm(p, gt)
                                              for _ in range(steps)])
    for fn in fns["dot_probe"] + fns["torch.mm"]:
        fn()
    torch.cuda.synchronize()
    for turn in range(PROBE_TURNS):
        order = list(sides) if turn % 2 == 0 else list(sides)[::-1]
        for side in order:
            sides[side].append(sum(cuda_ms(fn, 3) for fn in fns[side]))
    for side, ms in sides.items():
        each = ", ".join(f"{m:.4f}" for m in ms)
        say(f"time dot_probe turns, {side} over the six probes: min "
            f"{min(ms):.4f} / median {float(np.median(ms)):.4f} / max "
            f"{max(ms):.4f} ms of {len(ms)} turns ({each}) [{card}]")


def _epoch_on_the_card(engine: Engine, root: Path, raw: bool) -> None:
    """One Engine.train_epoch over DATA_BATCHES loader batches (the main
    path: launch counts set to 0 just before it, read just after), then
    validate over the same loader."""
    label = "raw wire (device_aug)" if raw else "uint8 wire (host crops)"
    ds = HypersimDataset(str(root), ["depth", "normal"],
                         augment=AugmentConfig(out_size=IMAGE, hflip_p=0.5,
                                               vflip_p=0.3),
                         paired_mode=False, uint8_output=True, raw_mode=raw)
    loader = DataLoader(ds, PATH_BATCH, shuffle=True, seed=0, num_workers=4,
                        drop_last=True)
    try:
        n = len(loader)
        require(n == DATA_BATCHES, f"{label}: {n} batches")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _zero_counts()
        loss, avg, last = engine.train_epoch(loader, progress=False)
        counts = _counts()
        seconds = time.perf_counter() - t0
        _no_experiment_launches(label)
        want = tuple(c * n for c in UNPAIRED_STEP_LAUNCHES)
        require(counts == want, f"engine {label}: {counts} launches of "
                                f"{KERNEL_NAMES}, expected {want}")
        require(all(np.isfinite(v) for v in avg.values()),
                f"engine {label}: metrics {avg}")
        require(avg["nan_detected"] == 0.0, f"engine {label}: skipped update")
        wire = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in last.items()}
        say(f"engine {label}: train_epoch of {n} batches of {PATH_BATCH} in "
            f"{seconds:.2f} s (first steps included), G_loss {loss:.4f}, "
            f"D_loss {avg['D_loss']:.4f}, nan_detected 0, launches {counts} "
            f"ok; the last batch on the card: {wire}")
        vloss, vavg, gx, fy, x, y = engine.validate(loader, progress=False)
        require(np.isfinite(vloss) and all(np.isfinite(v)
                                           for v in vavg.values()),
                f"engine {label} validate: {vavg}")
        for name, img in (("Gx", gx), ("Fy", fy)):
            require(img.shape == (PATH_BATCH, IMAGE, IMAGE, 3)
                    and np.isfinite(img).all(),
                    f"engine {label} validate {name} {img.shape}")
        require((x is None) == raw, f"engine {label} validate: input images")
        say(f"engine {label}: validate G_loss {vloss:.4f}; Gx, Fy "
            f"{(PATH_BATCH, IMAGE, IMAGE, 3)} finite")
    finally:
        loader.close()


def _augment_on_the_card(root: Path) -> None:
    """device_augment of one raw loader batch on the card against the port's
    CPU device_augment on the same frames and aug vectors."""
    ds = HypersimDataset(str(root), ["depth", "normal"],
                         augment=AugmentConfig(out_size=IMAGE, hflip_p=0.5,
                                               vflip_p=0.3),
                         paired_mode=False, raw_mode=True)
    loader = DataLoader(ds, PATH_BATCH, shuffle=True, seed=1, drop_last=True)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    for key in ("x", "y"):
        raw = torch.from_numpy(batch[f"{key}_raw"])
        aug = torch.from_numpy(batch[f"{key}_aug"])
        want = device_augment(raw, aug, IMAGE)
        got = device_augment(raw.to(DEV), aug.to(DEV), IMAGE)
        compare(f"device_augment {key} {tuple(raw.shape)} -> "
                f"{tuple(want.shape)} (card vs CPU)", got.cpu(), want,
                tol=AUG_TOL)


def _bench_child(card: str) -> dict:
    """``python -m vae_cyclegan_tpu_torch.bench`` at its defaults in a child
    process, but for the loader-only phase (``BENCH_LOADER_ONLY=0``: the
    host's decode capability, no device in the loop, and ~1 min of this
    script's time limit on a busy host); its JSON line, held to: no error
    key, a positive step and e2e rate, an e2e epoch of several batches, the
    unpaired step's launches per step, the world-1 group it ran through."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["BENCH_LOADER_ONLY"] = "0"
    proc = subprocess.run(
        [sys.executable, "-m", "vae_cyclegan_tpu_torch.bench"],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT, env=env,
        cwd=str(Path(__file__).resolve().parent))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "bench.log").write_text(proc.stdout + proc.stderr)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    require(proc.returncode == 0 and lines,
            f"bench exited {proc.returncode}: "
            f"{(lines or [proc.stderr[-500:]])[-1]}")
    out = json.loads(lines[-1])
    say(f"bench: {json.dumps(out)}")
    errors = [k for k in out if k.endswith("_error")]
    require(not errors, f"bench errors: {[(k, out[k]) for k in errors]}")
    require(out["value"] > 0, f"bench value {out['value']}")
    require(out["e2e_loader_images_per_sec"] > 0,
            f"bench e2e {out['e2e_loader_images_per_sec']}")
    require(out["e2e_batches_per_epoch"] >= 2,
            f"bench e2e epoch of {out['e2e_batches_per_epoch']} batches")
    require(out["launches_per_step"] == bench.UNPAIRED_STEP_LAUNCHES,
            f"bench launches_per_step {out['launches_per_step']}, expected "
            f"{bench.UNPAIRED_STEP_LAUNCHES}")
    require(out["device"] == card, f"bench device {out['device']}")
    require(out["unified"] == {"backend": "nccl", "world_size": 1},
            f"bench unified {out['unified']}")
    return out


def phase_data_engine(card: str) -> None:
    """The path users train through: a synthetic tree and its decoded-image
    cache, the loader, the copy to the card, on-card augmentation and the
    step inside Engine.train_epoch, on both wires; device_augment held to
    its CPU result; then the port's bench at its defaults."""
    t0 = time.perf_counter()
    say(f"data: native data plane {native.status()}")
    with tempfile.TemporaryDirectory() as td:
        bench._synthetic_hypersim_tree(td, PATH_BATCH * DATA_BATCHES)
        root = Path(td) / "hypersim"
        cache = DecodedImageCache(
            DecodedImageCache.build(root, Path(td) / "img.cache")).attach()
        say(f"data: synthetic tree and cache of {len(cache)} frames "
            f"(768x1024) in {time.perf_counter() - t0:.1f} s")
        try:
            task = create_task("cyclevaegan", model=ModelConfig(
                IMAGE, LATENT, BASE, torch.bfloat16), paired=False,
                device=DEV)
            task.init(0)
            engine = Engine(task, seed=0)
            for raw in (False, True):
                _epoch_on_the_card(engine, root, raw)
            del engine, task
            _augment_on_the_card(root)
        finally:
            data_datasets.set_decode_cache(None)
    torch.cuda.empty_cache()
    tb = time.perf_counter()
    _bench_child(card)
    say(f"data and engine phase: {time.perf_counter() - t0:.1f} s (the "
        f"bench child {time.perf_counter() - tb:.1f} s) [{card}]")


# phase 11: the drivers. The training run's tree: DRIVER_FRAMES 768x1024
# frames, split 0.75 / 0.25 (3 training batches of 4, 1 validation batch);
# the transfer runs split it 0.5 / 0.5 (2 training batches)
DRIVER_FRAMES = 16
# the port's InceptionV3 on the card (f32, TF32 off) against the same module
# on the CPU: |card - CPU| <= FID_TOL x the largest feature
FID_TOL = 1e-4


class _EpochProbe:
    """A thin wrapper the phase puts around Engine.train_epoch (the drivers'
    main path) and Engine.validate: each training epoch runs with every
    launch count set to 0 just before it and read just after, its steps
    counted; ``before`` (if set) sees the engine before the first step."""

    def __init__(self):
        self.epochs, self.valid = [], []
        self.before = None
        self._train, self._validate = Engine.train_epoch, Engine.validate
        self._step = Engine.train_step

    def __enter__(self):
        probe = self

        def train_step(engine, *a, **kw):
            probe.steps += 1
            return probe._step(engine, *a, **kw)

        def train_epoch(engine, loader, *a, **kw):
            if probe.before is not None:
                probe.before(engine)
                probe.before = None
            probe.steps = 0
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            out = probe._train(engine, loader, *a, **kw)
            torch.cuda.synchronize()
            probe.epochs.append({
                "task": engine.task.name, "epoch": kw.get("epoch"),
                "steps": probe.steps, "counts": _counts(),
                "stray": {n: fn.launches for n, fn in zip(EXP_NAMES,
                                                         EXP_WRAPPERS)
                          if fn.launches},
                "seconds": time.perf_counter() - t0, "avg": out[1]})
            return out

        def validate(engine, *a, **kw):
            out = probe._validate(engine, *a, **kw)
            probe.valid.append(out[1])
            return out

        Engine.train_step, Engine.train_epoch = train_step, train_epoch
        Engine.validate = validate
        return self

    def __exit__(self, *exc):
        Engine.train_step, Engine.train_epoch = self._step, self._train
        Engine.validate = self._validate


def _driver(module, argv, log: Path):
    """``module.main(module.build_parser().parse_args(argv))`` in this
    process, its console output appended to `log`."""
    import contextlib

    with open(log, "a") as f, contextlib.redirect_stdout(f):
        print(f"$ python -m {module.__name__} {' '.join(argv)}", flush=True)
        return module.main(module.build_parser().parse_args(argv))


def _check_epochs(probe: _EpochProbe, label: str, want_steps: int,
                  launches: tuple) -> list:
    """Each training epoch of the run: `want_steps` steps, `launches` per
    step (WRAPPERS order), no prototype kernel, metrics finite, no skipped
    update."""
    epochs, probe.epochs = probe.epochs, []
    require(epochs, f"{label}: no training epoch ran")
    for ep in epochs:
        want = tuple(c * ep["steps"] for c in launches)
        require(ep["steps"] == want_steps,
                f"{label} epoch {ep['epoch']}: {ep['steps']} steps")
        require(ep["counts"] == want,
                f"{label} epoch {ep['epoch']}: {ep['counts']} launches of "
                f"{KERNEL_NAMES}, expected {want}")
        require(not ep["stray"], f"{label}: prototype kernels {ep['stray']}")
        require(all(np.isfinite(v) for v in ep["avg"].values()),
                f"{label} epoch {ep['epoch']}: metrics {ep['avg']}")
        require(ep["avg"]["nan_detected"] == 0.0,
                f"{label} epoch {ep['epoch']}: skipped update")
    return epochs


def _tb_tags(run_dir: Path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    ea = EventAccumulator(str(run_dir / "tensorboard"),
                          size_guidance={"scalars": 0, "images": 0})
    ea.Reload()
    return ({t: [e.step for e in ea.Scalars(t)]
             for t in ea.Tags()["scalars"]},
            {t: [e.step for e in ea.Images(t)] for t in ea.Tags()["images"]})


def _same_state(label: str, task, engine, path: Path) -> None:
    """The task's state_dict, both Adam states (step included) and the
    engine's generator, bit for bit the checkpoint file's."""
    saved = torch.load(path / "state.pth", map_location="cpu",
                       weights_only=True)
    sd = task.state_dict()
    require(sd.keys() == saved["model_state_dict"].keys(), f"{label}: keys")
    for k, v in saved["model_state_dict"].items():
        require(torch.equal(sd[k].cpu(), v), f"{label}: {k}")
    for key, opt in task.optimizers().items():
        got, want = opt.state_dict(), saved["optimizer_states"][key]
        require(got["param_groups"] == want["param_groups"],
                f"{label}: {key} param_groups")
        require(got["state"].keys() == want["state"].keys() and got["state"],
                f"{label}: {key} state")
        for i, st in want["state"].items():
            for name, v in st.items():
                require(torch.equal(got["state"][i][name].cpu(), v),
                        f"{label}: {key} state {i} {name}")
    require(torch.equal(engine.generator.get_state(),
                        saved["generator_state"]), f"{label}: generator")


def _adam_step(path: Path) -> int:
    saved = torch.load(path / "state.pth", map_location="cpu",
                       weights_only=True)
    steps = {int(st["step"]) for osd in saved["optimizer_states"].values()
             for st in osd["state"].values()}
    require(len(steps) == 1, f"{path.name}: Adam steps {steps}")
    return steps.pop()


def _seeded_inception_state() -> dict:
    """A torchvision-layout inception_v3 state_dict from a seed: He-scaled
    conv weights, BatchNorm near identity (no weights are bundled)."""
    rng = np.random.RandomState(0)
    sd = {}
    for k, v in fid.InceptionV3().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("bn.weight"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif k.endswith(("bn.bias", "running_mean")):
            a = 0.1 * rng.randn(*shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            continue
        sd[k] = a.astype(np.float32)
    return sd


def _phase_fid(card: str, td: Path) -> None:
    """The port's InceptionV3 features on the card (f32, TF32 off) against
    the same module on the CPU at batch 4 of 256x256 inputs; fid_score of
    two small image sets on the card."""
    np.savez(td / "inception.npz", **_seeded_inception_state())
    gpu = fid.load_torch_inception(str(td / "inception.npz"), DEV)
    cpu = fid.load_torch_inception(str(td / "inception.npz"), "cpu")
    x = _images(PATH_BATCH, 21)
    feats = fid.make_feature_fn(gpu)
    want = fid.make_feature_fn(cpu)(x)
    got = feats(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = feats(x)
    ms = 1000 * (time.perf_counter() - t0)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    require(got.shape == want.shape == (PATH_BATCH, 2048) and scale > 0
            and np.isfinite(got).all(), f"fid features {got.shape}")
    require(err <= FID_TOL * scale, f"fid features: max_abs_err {err:.3e} "
                                    f"of {scale:.3e}")
    say(f"check fid InceptionV3 features {got.shape} (card f32 vs CPU, "
        f"256x256 resized to 299): max_abs_err={err:.3e} = "
        f"{err / scale:.2e} of the largest feature {scale:.3e} (tol "
        f"{FID_TOL:g} of it) ok; {ms:.1f} ms a batch of {PATH_BATCH} on the "
        f"card [{card}]")
    a = [img for img in _images(6, 22)]
    b = [np.clip(img * 0.5 + 0.3, 0, 1) for img in _images(6, 23)]
    same, diff = fid.fid_score(a, a, feats, 4), fid.fid_score(a, b, feats, 4)
    require(np.isfinite(same) and np.isfinite(diff) and diff > abs(same),
            f"fid_score same {same} vs different {diff}")
    say(f"fid_score on the card: 6 images against themselves {same:.4e}, "
        f"against 6 others {diff:.4f} ok")


def _phase_test_driver(card: str, runs: Path, data: Path, out: Path,
                       log: Path) -> None:
    """python -m vae_cyclegan_tpu_torch.test over the run: summary.json
    with finite l1/psnr/ssim_to_target. Where the machine has no
    matplotlib, the metrics are computed by test.group_metrics and the
    figures are not drawn."""
    import importlib.util

    t0 = time.perf_counter()
    if importlib.util.find_spec("matplotlib") is not None:
        _driver(test_driver, ["--runs_dir", str(runs), "--data_dir",
                              str(data), "--output_dir", str(out),
                              "--num_samples", str(PATH_BATCH)], log)
        seconds = time.perf_counter() - t0
        group = out / "hypersim" / "depth_to_normal"
        summary = json.loads((group / "summary.json").read_text())
        figures = sorted(p.name for p in group.glob("*.png"))
        require(len(figures) == PATH_BATCH + 1, f"test figures {figures}")
        what = f"summary.json and {len(figures)} figures"
    else:
        (run,) = test_driver.discover_runs(str(runs))
        models = {run["name"]: test_driver.load_model_for_inference(run)}
        loader = test_driver.build_test_loader(
            run["args"], str(data), max_samples=PATH_BATCH)
        try:
            summary = test_driver.group_metrics(models, loader)
        finally:
            loader.close()
        seconds = time.perf_counter() - t0
        what = "the metrics; figures not drawn (no matplotlib here)"
    require(summary["num_samples"] == PATH_BATCH,
            f"test samples {summary['num_samples']}")
    vals = {k: list(summary[k].values()) for k in (
        "l1_to_target", "psnr_to_target", "ssim_to_target")}
    require(all(len(v) == 1 and np.isfinite(v[0]) for v in vals.values()),
            f"test metrics {vals}")
    say(f"test driver: {what}; l1 {vals['l1_to_target'][0]:.4f}, psnr "
        f"{vals['psnr_to_target'][0]:.2f} dB, ssim "
        f"{vals['ssim_to_target'][0]:.4f} over {PATH_BATCH} samples in "
        f"{seconds:.2f} s (model load included): "
        f"{PATH_BATCH / seconds:.2f} images/s [{card}]")


def _phase_nan_dump(task, td: Path) -> None:
    """One NaN batch through the full-width task's train_step with dumping
    on: the update is skipped, one .npz is written with the loss, the batch
    and the skipped optimizer's parameters and gradients by name."""
    names = {id(p): n for n, p in task.nets.named_parameters()}
    before = {n: p.detach().clone() for n, p in task.nets.named_parameters()}
    batch = {"x": _images(PATH_BATCH, 31), "y": _images(PATH_BATCH, 32)}
    batch["x"][0, 5, 7, 1] = np.nan
    nan_dump.enable(td / "nan_run", max_dumps=1)
    try:
        m = task.train_step(batch)
    finally:
        nan_dump.disable()
    require(float(m["nan_detected"]) == 1.0, "nan step: not skipped")
    for n, p in task.nets.named_parameters():
        require(torch.equal(p, before[n]), f"nan step moved {n}")
    dumps = sorted((td / "nan_run" / "nan_dumps").glob("*.npz"))
    require(len(dumps) == 1, f"nan dumps {dumps}")
    dump = np.load(dumps[0])
    gen = [names[id(p)] for p in task.gen_params]
    want = ({"loss", "batch.x", "batch.y"} | {f"params.{n}" for n in gen}
            | {f"grads.{n}" for n in gen})
    require(set(dump.files) == want, f"nan dump keys {sorted(dump.files)[:5]}")
    require(not np.isfinite(dump["loss"]), f"nan dump loss {dump['loss']}")
    say(f"nan dump: the NaN batch's update skipped (parameters unmoved), "
        f"{dumps[0].name} with the loss, the batch and {len(gen)} parameters "
        f"and gradients of G and F ok")


def phase_drivers(card: str) -> None:
    """The port's entry points in process: python -m
    vae_cyclegan_tpu_torch.train (full-width bf16 cyclevaegan, unpaired,
    over a decoded-image cache that data.tools built) with the checkpoint,
    resume, transfer and NaN-dump checks, then .test over the run, then
    FID."""
    t0 = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    log = OUT_DIR / "drivers.log"
    log.write_text("")
    want_launches = UNPAIRED_STEP_LAUNCHES
    with tempfile.TemporaryDirectory() as tmp, _EpochProbe() as probe:
        td = Path(tmp)
        bench._synthetic_hypersim_tree(td, DRIVER_FRAMES)
        require(data_tools.main(["cache", "--root", str(td / "hypersim"),
                                 "--out", str(td / "img.cache")]) == 0,
                "data.tools cache")
        common = ["--data_dir", str(td), "--image_size", str(IMAGE),
                  "--base_width", str(BASE), "--latent_dim", str(LATENT),
                  "--precision", "bf16", "--batch_size", str(PATH_BATCH),
                  "--save_freq", "1", "--log_image_freq", "1",
                  "--num_workers", "2", "--quiet", "--decode_cache",
                  str(td / "img.cache")]
        runs = td / "runs"
        argv = ["--architecture", "cyclevaegan", "--epochs", "2",
                "--test_split", "0.25", "--output_dir", str(runs), *common]
        try:
            run = _driver(train_driver, argv, log)
        finally:
            data_datasets.set_decode_cache(None)
        epochs = _check_epochs(probe, "train cyclevaegan", 3, want_launches)
        require([ep["epoch"] for ep in epochs] == [0, 1],
                f"train epochs {[ep['epoch'] for ep in epochs]}")
        for ep in epochs:
            say(f"train driver epoch {ep['epoch'] + 1}: {ep['steps']} steps "
                f"at batch {PATH_BATCH}, launches {ep['counts']} = "
                f"{want_launches} a step ok; "
                f"{ep['avg']['images_per_sec']:.2f} images/s "
                f"(Engine.train_epoch), {ep['seconds']:.2f} s [{card}]")
        entries = sorted(p.name for p in run.iterdir())
        require(entries == ["args.json", "best_model", "checkpoint_epoch_1",
                            "checkpoint_epoch_2", "tensorboard"],
                f"run directory {entries}")
        scalars, images = _tb_tags(run)
        train_keys = {k for k, v in epochs[0]["avg"].items()
                      if not (k == "nan_detected" and v == 0.0)}
        want_scalars = ({"Loss/train", "Loss/test"}
                        | {f"Loss_Components_train/{k}" for k in train_keys}
                        | {f"Loss_Components_test/{k}" for k in probe.valid[0]})
        require(set(scalars) == want_scalars,
                f"TB scalars {sorted(set(scalars) ^ want_scalars)}")
        require(all(steps == [0, 1] for steps in scalars.values()),
                f"TB steps {scalars}")
        require(set(images) == {"depth/test_x", "normal/test_y",
                                "normal/test_Gx", "depth/test_Fy"},
                f"TB images {sorted(images)}")
        say(f"train driver: run directory {entries}, {len(scalars)} scalar "
            f"and {len(images)} image tags of train.py's schema ok")

        # the checkpoint on the card: load into a fresh task and engine
        task = create_task("cyclevaegan", model=ModelConfig(
            IMAGE, LATENT, BASE, torch.bfloat16), paired=False, device=DEV)
        task.init(99)
        engine = Engine(task, seed=99)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        load_checkpoint(task, run / "checkpoint_epoch_2", engine)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        _same_state("checkpoint_epoch_2 on the card", task, engine,
                    run / "checkpoint_epoch_2")
        t1 = time.perf_counter()
        save_checkpoint(task, 1, 0.0, {}, td / "saved", engine)
        save_s = time.perf_counter() - t1
        _same_state("saved again", task, engine, td / "saved")
        size = (td / "saved" / "state.pth").stat().st_size
        say(f"checkpoint: checkpoint_epoch_2 into a fresh task and engine on "
            f"the card, weights, both Adam states and the generator bit for "
            f"bit ok; save {save_s:.3f} s, load {load_s:.3f} s for "
            f"{size / 1e6:.1f} MB [{card}]")
        _phase_nan_dump(task, td)
        del task, engine
        torch.cuda.empty_cache()

        # resume from checkpoint_epoch_1 for one more epoch
        step1 = _adam_step(run / "checkpoint_epoch_1")
        argv = ["--architecture", "cyclevaegan", "--epochs", "2",
                "--test_split", "0.25", "--output_dir", str(runs),
                "--resume", str(run / "checkpoint_epoch_1"), *common]
        try:
            again = _driver(train_driver, argv, log)
        finally:
            data_datasets.set_decode_cache(None)
        require(again == run, f"resume run directory {again}")
        epochs = _check_epochs(probe, "resume cyclevaegan", 3, want_launches)
        require([ep["epoch"] for ep in epochs] == [1],
                f"resume epochs {[ep['epoch'] for ep in epochs]}")
        step2 = _adam_step(run / "checkpoint_epoch_2")
        require(step2 == step1 + 3, f"resume: Adam step {step1} -> {step2}")
        scalars, _ = _tb_tags(run)
        require(scalars["Loss/train"] == [0, 1],
                f"resume: Loss/train steps {scalars['Loss/train']}")
        say(f"resume: from checkpoint_epoch_1 at epoch 2, Adam step {step1} "
            f"-> {step2}, TensorBoard events past epoch 1 truncated ok")

        # Double* -> Cycle* transfer
        pre = td / "pretrain"
        common = [a for a in common if a not in ("--decode_cache",
                                                 str(td / "img.cache"))]
        dbl = _driver(train_driver, [
            "--architecture", "doubleae", "--paired", "--epochs", "1",
            "--test_split", "0.5", "--output_dir", str(pre), *common], log)
        _check_epochs(probe, "train doubleae", 2,
                      FAMILY_STEP_LAUNCHES["doubleae"])
        source = torch.load(dbl / "checkpoint_epoch_1" / "state.pth",
                            map_location="cpu", weights_only=True)
        encoder = {k[len("encoder."):]: v
                   for k, v in source["model_state_dict"].items()
                   if k.startswith("encoder.")}

        def transferred(engine):
            G, F = engine.task.nets["G"], engine.task.nets["F"]
            for net in (G, F):
                got = net.encoder.state_dict()
                for k, v in encoder.items():
                    require(torch.equal(got[k].cpu(), v),
                            f"transfer: encoder {k}")
            shared = ({p.untyped_storage().data_ptr() for p in G.parameters()}
                      & {p.untyped_storage().data_ptr()
                         for p in F.parameters()})
            require(not shared, f"transfer: G and F share {len(shared)} "
                                f"storages")

        probe.before = transferred
        _driver(train_driver, [
            "--architecture", "cycleae", "--paired", "--epochs", "1",
            "--test_split", "0.5", "--output_dir", str(pre),
            "--pretrained_doubleae", str(dbl / "checkpoint_epoch_1"),
            *common], log)
        require(probe.before is None, "transfer: the cycleae run took no step")
        _check_epochs(probe, "train cycleae", 2,
                      FAMILY_STEP_LAUNCHES["cycleae"])
        say("transfer: doubleae (1 epoch of 2 batches) -> cycleae "
            "--pretrained_doubleae: before the first step G's and F's "
            "encoders equal the Double encoder bit for bit, G and F share no "
            "storage ok")
        torch.cuda.empty_cache()

        _phase_test_driver(card, runs, td, td / "test_results", log)
        torch.cuda.empty_cache()
        _phase_fid(card, td)
    torch.cuda.empty_cache()
    say(f"drivers phase: {time.perf_counter() - t0:.1f} s [{card}]")

# phase 12: the generator export, rematerialization and the trajectories.
# Latencies of the loaded program and of generate: median of 25 after 3
# warm-ups, per batch size
EXPORT_ITERS = 25
# remat's batch: bench.py's default, where the memory it saves matters
REMAT_BATCH = 24
# one remat step's extra launches per generator pass: the recompute runs
# the pass's forward again (5 K1 and U4's and the tail's K3 reflect; the
# CPU test tests/test_torch_remat.py derives the same from the sites)
REMAT_PASS_LAUNCHES = (5, 0, 2, 0, 0)
# the trajectories: steps at the path's batch, and the bar on the bf16
# trajectory's means against f32's: max(TRAJ_BAR, TRAJ_BAND x the f32
# trajectory's one-ulp band). The band is the largest gap of four one-ulp
# twins of the f32 run (every parameter up, and three seeded up/down coin
# patterns), as the JAX package took the largest of five probes for vaegan:
# D_loss is chaotic after the first update, so one twin's gap is one draw,
# and against one draw the bf16 trajectory of a correct port would miss the
# bar about one time in four (a normal model of the two gaps; four twins:
# about one in twenty-five)
TRAJ_STEPS = 10
TRAJ_BAR, TRAJ_BAND = 0.02, 2.0
TRAJ_TWINS = ("f32_ulp", "f32_ulp1", "f32_ulp2", "f32_ulp3")


def _latency_ms(fn, iters: int) -> tuple:
    """(median, min, max) host ms of `fn` + a synchronize, after 3
    warm-ups."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat)), min(lat), max(lat)


def _phase_export(card: str, td: Path) -> None:
    """(a) the cyclevaegan generator exported with a symbolic batch, saved,
    loaded; the loaded program against generate at batch 1 and 4 (launches
    and outputs), latencies at 1, 4 and 16."""
    task = _task(torch.bfloat16, DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program = export_mod.export_generator(task)
    export_s = time.perf_counter() - t0
    path = td / "cyclevaegan.pt2"
    t0 = time.perf_counter()
    export_mod.save(program, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = export_mod.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    nodes = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("vct."):
            nodes[str(node.target)] = nodes.get(str(node.target), 0) + 1
    require(nodes == {"vct.in_act.default": 5, "vct.starved_conv.default": 2},
            f"export: vct nodes {nodes}")
    require(served.device.type == "cuda" and served.meta["batch"] == "symbolic",
            f"export: loaded on {served.device}, batch {served.meta['batch']}")
    say(f"export: cyclevaegan generator (bf16, {IMAGE}x{IMAGE}, symbolic "
        f"batch) with {nodes} in its graph; export {export_s:.2f} s, save "
        f"{save_s:.2f} s ({path.stat().st_size / 1e6:.1f} MB), load "
        f"{load_s:.2f} s [{card}]")
    for b in BATCHES:
        x = torch.as_tensor(_images(b, 60 + b), device=DEV)
        eps = served.noise(b, b)
        if b in (1, PATH_BATCH):
            # the main path: the loaded program's launches, then generate's
            _zero_counts()
            got = served.run(x, eps)
            torch.cuda.synchronize()
            program_launches = _counts()
            _zero_counts()
            want = task.generate({"x": x}, eps=eps).float()
            torch.cuda.synchronize()
            generate_launches = _counts()
            _no_experiment_launches("export")
            require(program_launches == generate_launches == (5, 0, 2, 0, 0),
                    f"export batch {b}: the program launched "
                    f"{program_launches}, generate {generate_launches} of "
                    f"{KERNEL_NAMES}")
            require(got.dtype == torch.float32
                    and tuple(got.shape) == (b, IMAGE, IMAGE, 3)
                    and bool(torch.isfinite(got).all()),
                    f"export batch {b}: {got.dtype} {tuple(got.shape)}")
            if torch.equal(got, want):
                say(f"check export batch {b}: the loaded program's output "
                    f"equals generate's bit for bit; launches "
                    f"{program_launches} = generate's ok")
            else:
                compare(f"export batch {b} program vs generate (bf16 "
                        f"tolerance)", got, want, TOL[torch.bfloat16])
        ms_p = _latency_ms(lambda: served.run(x, eps), EXPORT_ITERS)
        ms_g = _latency_ms(lambda: task.generate({"x": x}, eps=eps),
                           EXPORT_ITERS)
        say(f"time export batch {b}: loaded program median {ms_p[0]:.3f} ms "
            f"(min {ms_p[1]:.3f}, max {ms_p[2]:.3f}), generate median "
            f"{ms_g[0]:.3f} ms (min {ms_g[1]:.3f}, max {ms_g[2]:.3f}) of "
            f"{EXPORT_ITERS} [{card}]")
    del task, program, served
    torch.cuda.empty_cache()


def _remat_run(remat: bool, batch: dict, eps: list) -> dict:
    """A full-width bf16 cyclevaegan task (paired) with or without remat:
    one step on the given noise (its metrics), the launches per step and
    then the median of 5 timed steps after 2 warm-ups, and the peak device
    memory over those."""
    task = create_task("cyclevaegan", model=ModelConfig(
        IMAGE, LATENT, BASE, torch.bfloat16, remat=remat), device=DEV)
    task.init(0)
    torch.cuda.synchronize()
    _zero_counts()
    metrics = _finite_metrics(task.train_step(batch, eps=eps))
    launches = _counts()
    _no_experiment_launches("remat")
    gen = torch.Generator(device=DEV).manual_seed(1)
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
        require(vals["nan_detected"] == 0.0, "remat: a timed step skipped")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    del task
    torch.cuda.empty_cache()
    return {"metrics": metrics, "launches": launches,
            "ms": float(np.median(lat)), "min": min(lat), "max": max(lat),
            "peak": peak}


def _phase_remat(card: str) -> None:
    """(b) batch-24 steps with and without remat, in turns: one step's
    metrics on the same noise, launches per step, step time, peak memory."""
    b = REMAT_BATCH
    batch = {"x": torch.as_tensor(_images(b, 70), device=DEV),
             "y": torch.as_tensor(_images(b, 71), device=DEV)}
    rng = np.random.RandomState(72)
    eps = [rng.randn(b, IMAGE // 16, IMAGE // 16, LATENT).astype(np.float32)
           for _ in range(6)]
    plain = _remat_run(False, batch, eps)
    remat = _remat_run(True, batch, eps)
    want = tuple(s + 6 * r for s, r in zip(STEP_LAUNCHES, REMAT_PASS_LAUNCHES))
    require(plain["launches"] == STEP_LAUNCHES and remat["launches"] == want,
            f"remat launches per step {remat['launches']} (expected {want}), "
            f"without {plain['launches']} (expected {STEP_LAUNCHES})")
    got, ref = remat["metrics"], plain["metrics"]
    same = all(got[k] == ref[k] for k in ref) and set(got) == set(ref)
    if same:
        say("check remat step vs plain step (batch 24, bf16, same weights "
            "and noise): every metric equal bit for bit ok")
    else:
        worst = max(abs(got[k] - ref[k]) / (abs(ref[k]) + 1e-3) for k in ref)
        ok = all(abs(got[k] - ref[k]) <= STEP_METRIC_RTOL * abs(ref[k]) + 1e-5
                 for k in ref)
        say(f"check remat step vs plain step (batch 24, bf16): metrics differ "
            f"in their last bits, max relative error {worst:.3e} (rtol "
            f"{STEP_METRIC_RTOL:g}, the card-vs-CPU step bound) "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"remat step metrics {got} vs {ref}")
    require(remat["peak"] < plain["peak"],
            f"remat peak {remat['peak']:.0f} MiB not below {plain['peak']:.0f}")
    for label, r in (("without remat", plain), ("remat", remat)):
        say(f"time train_step cyclevaegan batch {b} bf16 {label}: median "
            f"{r['ms']:.2f} ms of 5 (min {r['min']:.2f}, max {r['max']:.2f}), "
            f"{b / r['ms'] * 1e3:.1f} img/s, peak memory {r['peak']:.0f} MiB, "
            f"launches per step {dict(zip(KERNEL_NAMES, r['launches']))} "
            f"[{card}]")
    say(f"remat at batch {b}: peak {remat['peak']:.0f} / {plain['peak']:.0f} "
        f"MiB = {remat['peak'] / plain['peak']:.3f}, step time "
        f"{remat['ms'] / plain['ms']:.3f}x [{card}]")


def _trajectories(runs, instance_norm: str, out: Path) -> dict:
    """``python -m vae_cyclegan_tpu_torch.parity_curves`` in process:
    cyclevaegan at full width, TRAJ_STEPS steps at the path's batch, every
    run from the same weights and data; its record, with the launches the
    runs made (counts set to 0 just before, read just after)."""
    _zero_counts()
    rc = parity_curves.main([
        "--archs", "cyclevaegan", "--steps", str(TRAJ_STEPS),
        "--image_size", str(IMAGE), "--batch", str(PATH_BATCH),
        "--base_width", str(BASE), "--latent_dim", str(LATENT),
        "--instance_norm", instance_norm, "--runs", *runs,
        "--reference", "f32", "--out", str(out)])
    torch.cuda.synchronize()
    require(rc == 0, f"parity_curves exited {rc}")
    (rec,) = json.loads(out.read_text())
    rec["launches"] = _counts()
    _no_experiment_launches("trajectory")
    for run in runs:
        values = rec[f"{run}_G_loss"] + rec[f"{run}_D_loss"]
        require(all(np.isfinite(values)), f"trajectory {run}: {values}")
        require(not any(rec[f"{run}_nan_detected"]),
                f"trajectory {run} skipped an update")
    return rec


def _phase_trajectory(card: str) -> None:
    """(c) the bf16 trajectory (the kernels) against the f32 one, beside
    the f32 trajectory's own one-ulp band; then the tiled configuration's
    bf16 trajectory against its f32 one, under the same band."""
    OUT_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    auto = _trajectories(["bf16", "f32", *TRAJ_TWINS], "auto",
                         OUT_DIR / "parity_curves.json")
    per_run = tuple(TRAJ_STEPS * n for n in STEP_LAUNCHES)
    runs = 2 + len(TRAJ_TWINS)
    require(auto["launches"] == tuple(runs * n for n in per_run),
            f"trajectory launches {auto['launches']}: expected {runs} runs x "
            f"{per_run}")
    band = {k: max(auto["gaps"][t][k]["mean"] for t in TRAJ_TWINS)
            for k in ("G_loss", "D_loss")}
    for twin in TRAJ_TWINS:
        say(f"trajectory f32 one-ulp twin {twin}: mean gaps to f32 " + ", ".join(
            f"{k} {g['mean']:.4%}" for k, g in auto["gaps"][twin].items()))
    tiled = _trajectories(["bf16", "f32"], "tiled",
                          OUT_DIR / "parity_curves_tiled.json")
    per_run = tuple(TRAJ_STEPS * n for n in TILED_STEP_LAUNCHES)
    require(tiled["launches"] == tuple(2 * n for n in per_run),
            f"tiled trajectory launches {tiled['launches']}: expected 2 runs "
            f"x {per_run}")
    for label, rec in (("auto", auto), ("tiled", tiled)):
        for run in rec["runs"]:
            means = ", ".join(
                f"{k} mean {np.mean(rec[f'{run}_{k}']):.5f}"
                for k in ("G_loss", "D_loss"))
            say(f"trajectory {label} {run} ({TRAJ_STEPS} steps, batch "
                f"{PATH_BATCH}): {means}; G_loss "
                f"{[round(v, 4) for v in rec[f'{run}_G_loss']]}")
        for key, gap in rec["gaps"]["bf16"].items():
            bar = max(TRAJ_BAR, TRAJ_BAND * band[key])
            ok = gap["mean"] <= bar
            say(f"check trajectory {label} bf16 vs f32 {key}: mean gap "
                f"{gap['mean']:.4%} (largest step gap {gap['max']:.4%}); bar "
                f"max({TRAJ_BAR:.0%}, {TRAJ_BAND:g} x the f32 one-ulp band "
                f"{band[key]:.4%}, the largest of {len(TRAJ_TWINS)} twins) = "
                f"{bar:.4%} {'ok' if ok else 'FAIL'}")
            require(ok, f"trajectory {label} bf16 vs f32 {key}")
    say(f"trajectory phase: {time.perf_counter() - t0:.1f} s (curves in "
        f"{OUT_DIR}/parity_curves*.json) [{card}]")


def phase_export_remat_trajectory(card: str) -> None:
    """Phase 12: (a) export, (b) remat, (c) trajectories, then the host
    cost per call of the custom-op path."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _phase_export(card, Path(tmp))
    _phase_remat(card)
    _phase_trajectory(card)
    us = host_cost.measure()
    say("host us per call through the vct ops: " + ", ".join(
        f"{k} {v:.1f}" for k, v in us.items()) + f" [{card}]")
    say(f"phase 12 (export, remat, trajectories): "
        f"{time.perf_counter() - t0:.1f} s [{card}]")


# Phase 13, data parallelism. The world-1 NCCL phase: bench.py's batch, the
# paired cyclevaegan at full width; plain runs of its first step from one
# state, whose spread the world-1 step must stay within; timed blocks of
# DP_STEPS steps after DP_WARMUP, in turns plain, world 1, world 1, plain.
DP_BATCH = 24
DP_PLAIN_RUNS = 3
DP_WARMUP, DP_STEPS = 2, 5
# the two-rank phase: two gloo ranks on the one card, 2 samples each
DP2_BATCH = 4


def _dp_state(task) -> dict:
    """The task's parameters and buffers, copied (its Adams are fresh)."""
    return {k: v.detach().clone() for k, v in task.state_dict().items()}


def _dp_restore(task, state: dict) -> None:
    task.load_state_dict(state)
    for opt in task.optimizers().values():
        opt.state.clear()


def _dp_step(engine, task, state, batch, eps) -> tuple:
    """(metrics, parameters and buffers) of the first step from `state`."""
    _dp_restore(task, state)
    metrics = _finite_metrics(engine.train_step(batch, eps=eps))
    require(metrics["nan_detected"] == 0.0, "data parallel: step skipped")
    return metrics, {k: v.detach().float().cpu().clone()
                     for k, v in task.state_dict().items()}


def _dp_gaps(a: tuple, b: tuple) -> tuple:
    """(per metric |a - b|, the largest parameter or buffer difference)."""
    metric = {k: abs(a[0][k] - b[0][k]) for k in a[0]}
    param = max(float((a[1][k] - b[1][k]).abs().max()) for k in a[1])
    return metric, param


class _SyncProbe:
    """dp.sync while installed: every call's time on the card (CUDA events
    around the flatten, the all_reduce and the views) and, with `compare`,
    its inputs against its outputs bit for bit (at world 1 the mean of one
    rank is the rank's own)."""

    def __init__(self, compare: bool = True):
        self.calls = []
        self.equal = True
        self.compare = compare
        self.orig = dp.sync

    def __call__(self, tensors):
        tensors = list(tensors)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.orig(tensors)
        end.record()
        if self.compare:
            self.equal &= all(torch.equal(a.detach(), b)
                              for a, b in zip(tensors, out))
        self.calls.append((sum(t.numel() for t in tensors), start, end))
        return out

    def __enter__(self):
        dp.sync = self
        return self

    def __exit__(self, *exc):
        dp.sync = self.orig

    def per_step_ms(self, steps: int) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for _, s, e in self.calls) / steps


def _dp_time(engine, batch, label: str, card: str) -> tuple:
    """(median ms of DP_STEPS steps after DP_WARMUP, peak MiB)."""
    for _ in range(DP_WARMUP):
        engine.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        vals = _finite_metrics(engine.train_step(batch))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        require(vals["nan_detected"] == 0.0, f"{label}: timed step skipped")
    med = float(np.median(lat))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    say(f"time train_step data parallel {label} batch {DP_BATCH} bf16: "
        f"median {med:.2f} ms of {len(lat)} (min {min(lat):.2f}, max "
        f"{max(lat):.2f}), peak memory {peak:.0f} MiB [{card}]")
    return med, peak


def _dp2_rank(rank: int, init: str, inputs: str, out: str) -> None:
    """One of two gloo ranks on the one card (phase 13's child)."""
    import torch.distributed as tdist

    tdist.init_process_group("gloo", init_method=init, rank=rank,
                             world_size=2)
    try:
        torch.cuda.set_device(0)
        data = torch.load(inputs, weights_only=False)
        task = _task(torch.bfloat16, DEV)
        task.load_state_dict(data["state"])
        engine = Engine(task, seed=0, group=tdist.group.WORLD)
        lo, hi = mesh.shard_rows(DP2_BATCH, rank, 2)
        metrics = engine.train_step(
            {k: v[lo:hi].to(DEV) for k, v in data["batch"].items()},
            eps=[e[lo:hi] for e in data["eps"]])
        torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                    "state": {k: v.detach().cpu() for k, v in
                              task.state_dict().items()}},
                   Path(out) / f"rank{rank}.pt")
    finally:
        tdist.destroy_process_group()


def _phase_two_ranks(card: str, task, state: dict) -> None:
    """Two spawned gloo ranks on cuda:0, one step at a global batch of
    DP2_BATCH, 2 samples a rank. Every metric of a step is taken before its
    updates, so the ranks' meaned metrics must be the mean of this
    process's plain step on each rank's 2 samples (the same shapes, so the
    same kernels and algorithms: within rounding of the mean, bar
    STEP_METRIC_RTOL); their update is held against this process's world-1
    step on the 4 samples (one Adam step: at bf16 and another batch shape
    the gradients differ beyond rounding, so a batch of 4 is no bit-level
    reference); the ranks' parameters and buffers bit for bit equal."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    rng = np.random.RandomState(60)
    batch = {k: torch.as_tensor(_images(DP2_BATCH, 61 + i))
             for i, k in enumerate(("x", "y"))}
    eps = [rng.randn(DP2_BATCH, IMAGE // 16, IMAGE // 16, LATENT).astype(
        np.float32) for _ in task.train_passes]
    plain = Engine(task, seed=0)
    shards = []
    for r in range(2):
        lo, hi = mesh.shard_rows(DP2_BATCH, r, 2)
        shards.append(_dp_step(plain, task, state, {
            k: v[lo:hi].to(DEV) for k, v in batch.items()},
            [e[lo:hi] for e in eps])[0])
    want = {k: (shards[0][k] + shards[1][k]) / 2 for k in shards[0]}
    world1 = _dp_step(Engine(task, seed=0,
                             group=torch.distributed.group.WORLD),
                      task, state, {k: v.to(DEV) for k, v in batch.items()},
                      eps)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = str(Path(tmp) / "inputs.pt")
        torch.save({"state": state, "batch": batch, "eps": eps}, inputs)
        mp.start_processes(
            _dp2_rank, args=(f"tcp://127.0.0.1:{mesh.free_port()}", inputs,
                             tmp), nprocs=2, start_method="spawn")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
    same = all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k])
               for k in ranks[0]["state"])
    require(same, "two ranks: parameters and buffers differ across ranks")
    got = ranks[0]["metrics"]
    worst = max(abs(got[k] - v) / (abs(v) + 1e-3) for k, v in want.items())
    ok = set(got) == set(want) and all(
        abs(got[k] - v) <= STEP_METRIC_RTOL * abs(v) + 1e-5
        for k, v in want.items())
    w1 = max(abs(got[k] - v) / (abs(v) + 1e-3) for k, v in world1[0].items())
    lr = task.oc.lr
    par = max(float((ranks[0]["state"][k].float() - v).abs().max())
              for k, v in world1[1].items() if not k.endswith(("_u", "_v")))
    say(f"check two gloo ranks on one card (cyclevaegan bf16, global batch "
        f"{DP2_BATCH}, 2 a rank): metrics vs the mean of the plain step on "
        f"each rank's samples max relative error {worst:.3e} (rtol "
        f"{STEP_METRIC_RTOL:g}, atol 1e-5) {'ok' if ok else 'FAIL'} (vs "
        f"world 1 on all {DP2_BATCH}: {w1:.3e}); parameters vs world 1 "
        f"max_abs_err {par:.3e} = {par / lr:.3f} lr (bound 2 lr + 1e-6); "
        f"ranks bit for bit equal; {time.perf_counter() - t0:.1f} s [{card}]")
    require(ok, f"two ranks vs the shards' plain steps: {got} vs {want}")
    require(par <= 2 * lr + 1e-6, "two ranks vs world 1 parameters")


def phase_data_parallel(card: str) -> None:
    """Phase 13: (a) the world-1 NCCL group on the card: the synced
    gradients of a full-width batch-24 cyclevaegan step bit for bit the
    local ones, its launches those of the plain step, its first step within
    the plain step's run-to-run spread (DP_PLAIN_RUNS runs from one state:
    each metric within the plain runs' range widened by their largest
    pairwise gap, the parameters within one Adam step), the sync's cost per
    step (CUDA events) and the step's median and peak memory beside the
    plain step's; (b) two gloo ranks on the one card against world 1."""
    t0 = time.perf_counter()
    mesh.make_group(1, DEV, 0, f"tcp://127.0.0.1:{mesh.free_port()}")
    try:
        say(f"data parallel: world-1 group, backend "
            f"{torch.distributed.get_backend()}")
        task = _task(torch.bfloat16, DEV)
        state = _dp_state(task)
        rng = np.random.RandomState(50)
        batch = {"x": torch.as_tensor(_images(DP_BATCH, 51), device=DEV),
                 "y": torch.as_tensor(_images(DP_BATCH, 52), device=DEV)}
        eps = [rng.randn(DP_BATCH, IMAGE // 16, IMAGE // 16, LATENT).astype(
            np.float32) for _ in task.train_passes]
        plain = Engine(task, seed=0)
        unified = Engine(task, seed=0, group=torch.distributed.group.WORLD)
        runs = [_dp_step(plain, task, state, batch, eps)
                for _ in range(DP_PLAIN_RUNS)]
        # the main path of this phase: the counts cover exactly this step
        _zero_counts()
        with _SyncProbe() as probe:
            got = _dp_step(unified, task, state, batch, eps)
        per = _counts()
        require(per == STEP_LAUNCHES, f"world-1 step: {per} launches of "
                f"{KERNEL_NAMES}, expected {STEP_LAUNCHES}")
        _no_experiment_launches("world-1 step")
        values = sorted(n for n, _, _ in probe.calls)
        say(f"check world-1 step: {len(probe.calls)} syncs of {values} "
            f"values; synced == local bit for bit: {probe.equal}; launches "
            f"{per} ok")
        require(probe.equal, "world-1 sync changed a gradient")
        require(len(probe.calls) == 3, "world-1 step: expected a sync per "
                "optimizer and one of the metrics")
        pairs = [_dp_gaps(a, b) for i, a in enumerate(runs)
                 for b in runs[i + 1:]]
        spread = {k: max(m[k] for m, _ in pairs) for k in got[0]}
        spread_par = max(p for _, p in pairs)
        bad = [k for k, v in got[0].items()
               if not (min(r[0][k] for r in runs) - spread[k] <= v
                       <= max(r[0][k] for r in runs) + spread[k])]
        _, par = _dp_gaps(got, runs[0])
        lr = task.oc.lr
        rel = {k: spread[k] / (abs(runs[0][0][k]) + 1e-3) for k in spread}
        say(f"check world-1 step vs {DP_PLAIN_RUNS} plain runs from one "
            f"state (batch {DP_BATCH}, bf16): plain spread G_loss "
            f"{rel['G_loss']:.3e}, D_loss {rel['D_loss']:.3e} relative, "
            f"largest metric {max(rel.values()):.3e}, parameters "
            f"{spread_par:.3e}; world-1 metrics outside the spread: {bad}; "
            f"parameters vs plain run 1 {par:.3e} = {par / lr:.3f} lr "
            f"(bound 2 lr + 1e-6)")
        require(not bad, f"world-1 step outside the plain spread: {bad}")
        require(par <= 2 * lr + 1e-6, "world-1 step parameters")
        times = {}
        for label in ("plain", "world 1", "world 1 again", "plain again"):
            engine = plain if label.startswith("plain") else unified
            with _SyncProbe(compare=False) as probe:
                med, peak = _dp_time(engine, batch, label, card)
                sync = probe.per_step_ms(DP_WARMUP + DP_STEPS)
            times[label] = (med, peak, sync)
        say(f"data parallel world 1 vs plain, batch {DP_BATCH}: step median "
            f"{times['world 1'][0]:.2f} / {times['world 1 again'][0]:.2f} "
            f"ms vs {times['plain'][0]:.2f} / {times['plain again'][0]:.2f}; "
            f"sync (flatten + all_reduce + views, both optimizers and the "
            f"metrics) {times['world 1'][2]:.3f} / "
            f"{times['world 1 again'][2]:.3f} ms per step; peak memory "
            f"{times['world 1'][1]:.0f} vs {times['plain'][1]:.0f} MiB "
            f"[{card}]")
        del plain, unified, runs, batch
        torch.cuda.empty_cache()
        _phase_two_ranks(card, task, state)
    finally:
        mesh.destroy()
    say(f"phase 13 (data parallelism): {time.perf_counter() - t0:.1f} s "
        f"[{card}]")


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
    torch.cuda.empty_cache()
    phase_data_engine(card)
    torch.cuda.empty_cache()
    phase_drivers(card)
    torch.cuda.empty_cache()
    phase_export_remat_trajectory(card)
    torch.cuda.empty_cache()
    phase_data_parallel(card)
    # the kernels line: which phase drives each kernel. K1 (in_act), K3
    # (starved_conv, starved_conv_zero_same) and K4 (starved_conv_dw): the
    # serving and training paths (phases 4, 5, 7), the engine (10) and the
    # drivers (11), their launches from phase 5's three training steps; K2
    # (in_act_tiled): the tiled training path (6); K5-K8: the prototypes'
    # entry points (8), their launches from those runs
    conv_src = "vae_cyclegan_tpu_torch/csrc/starved_conv.cu"
    sources = {"conv_proto": "vae_cyclegan_tpu_torch/csrc/conv_proto.cu",
               "lowcin_conv_cm": "vae_cyclegan_tpu_torch/csrc/lowcin_conv.cu",
               "lowcin_conv_nhwc": "vae_cyclegan_tpu_torch/csrc/lowcin_nhwc.cu",
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
    if sys.argv[1:] == ["--k8-device"]:  # probe_device's child process
        kernels.load()
        print(json.dumps(probe_device_ms()), flush=True)
        sys.exit(0)
    try:
        main()
    except Exception as exc:  # report and exit non-zero without the result
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
