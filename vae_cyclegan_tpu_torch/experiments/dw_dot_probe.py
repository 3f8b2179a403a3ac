"""K8: the dw dot probe, ``out (mk, nk) f32 = sum over steps of p . g^T``,
each step's whole product computed afresh and added to an f32 accumulator in
step order.

Counterpart of ``experiments/dw_dot_probe.py`` (``make`` ``:25``, its
``pallas_call`` ``:39``; the probes ``:63-74``). That script timed only the
MXU dots of the weight-gradient kernel's candidate orientations for the k7
and k3 starved convs, on operands held in VMEM over as many grid steps as
the production kernel takes. ``csrc/dot_probe.cu`` splits each output tile's
K over a thread-block cluster: every CTA loads its rows of p and g over its
K slice into shared memory once and runs all the steps from there on the
card's tensor cores (bf16) or CUDA cores (f32), and per step each rank
sends its partial tile, quad by quad, to the ranks that own them
(``st.async`` into their shared memory), which sum them in rank order.
:func:`plan` picks the tile, the cluster and the K slices. Unlike the JAX
script, importing this module runs no probe.

    python -m vae_cyclegan_tpu_torch.experiments.dw_dot_probe [--device cuda]

runs the six probes with the JAX script's names and all-ones bf16 operands
and prints ms per call (ITERS calls per window; JAX timed 20 in one window).
``--batch`` is accepted and unused: the probes' shapes are fixed.
"""

from __future__ import annotations

import ctypes
import functools
import json
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.experiments.common import (
    check_operands,
    launch,
    parse_args,
    resolve_device,
    rup,
)
from vae_cyclegan_tpu_torch.experiments.timing import median_ms, ms_text
from vae_cyclegan_tpu_torch.ops.instance_norm import DTYPE_CODES

# the starved k7 conv's production geometry (dw_dot_probe.py:20-23)
K, WP, R = 7, 262, 16
L = R * WP             # 4192 pixels of a chunk
LP = L + K - 1         # 4198
MX = (R + K - 1) * WP  # 5764: the padded-x domain of a chunk
# (name, mk, nk, kk, steps): dw_dot_probe.py:65-74
SHAPES = [
    ("tail dw current (21,448,Lp)", 24, 448, LP, 384),
    ("tail dw nonswap (448,21->24)", 448, 24, LP, 384),
    ("tail dw wide (64,147,Mx)", 64, 152, MX, 384),
    ("head dw wide (64,147,Mx)", 64, 152, MX, 384),
    ("u4 dw current (96,192)", 96, 192, 16 * 514 + 2, 24 * 8),
    ("u4 dw wide (32,9*64=576)", 32, 576, 18 * 514, 24 * 8),
]
ITERS = 5

# csrc/dot_probe.cu's launch geometry: a tile is TILE_M rows of p by `tn`
# rows of g (one of TILE_NS); a CTA is WARPS warps in warp tiles of TILE_M x
# 16, WARPS / (tn / 16) groups of them splitting the CTA's K slice; each
# partial-tile row holds tn + PART_PAD floats
TILE_M = 32
TILE_NS = (16, 32, 64)
# the preferred width: with clusters of a power of two, 32 x 32 tiles were
# the fastest, or within 1% of it, at every probe on the card (:func:`sweep`;
# PERF.md, §6)
TILE_N = 32
WARPS = 8
PART_PAD = 8
# Clusters of a power of two CTAs: the plan among them came within 4% of
# the best of every size over the six probes, and most other sizes ran
# slower at the same waves, the card placing fewer of them at once or two
# CTAs on one SM (:func:`sweep`; PERF.md, §6). Above 8 the launch needs
# the non-portable attribute.
CLUSTERS = (1, 2, 4, 8, 16)
MAX_CLUSTER = 16       # the kernel takes any cluster up to this
SMEM_LIMIT = 227 * 1024
SM_SMEM = 228 * 1024   # an SM's shared memory, 1 KB of it reserved per CTA
CTAS_PER_SM = 2        # the kernel's __launch_bounds__ (128 registers)
SMS = 132              # the H100's SMs


class Plan(NamedTuple):
    """K8's launch: tiles of TILE_M x tn, each a cluster of `cluster` CTAs,
    rank r contracting K over [r kslice, min(kk, (r + 1) kslice))."""
    tn: int
    cluster: int
    kslice: int
    tiles: int
    ctas: int
    smem: int    # shared bytes a CTA

    def slices(self, kk: int) -> List[Tuple[int, int]]:
        return [(r * self.kslice, min(kk, (r + 1) * self.kslice))
                for r in range(self.cluster)]


def share(tn: int, cluster: int) -> int:
    """Quads (4 floats) of a tile each rank owns in the exchange."""
    return -(-(TILE_M * tn // 4) // cluster)


def smem_bytes(tn: int, kslice: int, dtype: torch.dtype,
               cluster: int) -> int:
    """A CTA's shared bytes (``geometry`` in csrc/dot_probe.cu): the operand
    rows over the K slice (bf16 rows an odd number of 16-byte chunks apart,
    f32 rows an odd number of words), the K groups' partial tiles, two
    receive slots of one share from every rank, two mbarriers."""
    if dtype == torch.bfloat16:
        chunks = kslice // 8
        stride = (chunks + 1 if chunks % 2 == 0 else chunks) * 16
    else:
        stride = (kslice + 1) * 4
    kgroups = WARPS // (tn // 16)
    return (rup((TILE_M + tn) * stride, 16)
            + kgroups * TILE_M * (tn + PART_PAD) * 4
            + 2 * cluster * share(tn, cluster) * 16 + 16)


def candidates(mk: int, nk: int, kk: int, dtype: torch.dtype,
               clusters=CLUSTERS) -> List[Plan]:
    """Every launch K8 can take for p (mk, kk) and g (nk, kk) of `dtype`
    with cluster sizes from `clusters`: each rank gets a nonempty K slice, a
    multiple of 16 long (so small kk shrinks the cluster), and owns quads of
    the tile, and its shared memory fits SMEM_LIMIT."""
    out = []
    for tn in TILE_NS:
        tiles = -(-mk // TILE_M) * -(-nk // tn)
        for cluster in clusters:
            kslice = rup(-(-kk // cluster), 16)
            if ((cluster - 1) * kslice >= kk or (cluster - 1)
                    * share(tn, cluster) >= TILE_M * tn // 4):
                continue  # a rank without K, or without quads
            smem = smem_bytes(tn, kslice, dtype, cluster)
            if smem <= SMEM_LIMIT:
                out.append(Plan(tn, cluster, kslice, tiles, tiles * cluster,
                                smem))
    return out


@functools.lru_cache(maxsize=None)
def plan(mk: int, nk: int, kk: int, dtype: torch.dtype) -> Plan:
    """The launch of K8 for p (mk, kk) and g (nk, kk) of `dtype`: among
    :func:`candidates`, the fewest waves of CTAs (:func:`waves`), then a tile
    TILE_N wide, then the fewest multiply-adds the busiest SM does per step,
    the fewest CTAs, the fewest shared bytes and the smallest cluster.
    Raises ValueError where none fits (kk beyond what 16 CTAs hold)."""
    found = candidates(mk, nk, kk, dtype)
    if not found:
        raise ValueError(f"dot_probe: no launch holds kk={kk} of {dtype} in "
                         f"the shared memory of {CLUSTERS[-1]} CTAs")
    return min(found, key=lambda pl: (
        waves(pl), pl.tn != TILE_N, busiest(pl), pl.ctas, pl.smem,
        pl.cluster))


def busiest(pl: Plan) -> int:
    """Multiply-adds per step of the SM with the most CTAs of the plan."""
    return -(-pl.ctas // SMS) * TILE_M * pl.tn * pl.kslice


def waves(pl: Plan) -> int:
    """Waves of CTAs the plan takes over SMS SMs, as many a SM as its shared
    memory and CTAS_PER_SM allow (the card's GPCs may place fewer clusters
    at once: :func:`resident` asks it)."""
    per_sm = min(CTAS_PER_SM, SM_SMEM // (pl.smem + 1024))
    return -(-pl.ctas // (SMS * per_sm))


def resident(pl: Plan, kk: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(shared bytes a CTA, clusters the card places at once) of plan `pl`,
    from the built library (cudaOccupancyMaxActiveClusters), so it needs
    the card."""
    out = (ctypes.c_longlong * 2)()
    kernels.check(kernels.load().vct_dot_probe_query(
        kk, DTYPE_CODES[dtype], pl.tn, pl.cluster, pl.kslice, out),
        "vct_dot_probe_query")
    return out[0], out[1]


def check_probe(p: torch.Tensor, g: torch.Tensor, steps: int) -> None:
    if (p.dim() != 2 or g.dim() != 2 or p.shape[1] != g.shape[1]
            or 0 in p.shape or 0 in g.shape):
        raise ValueError(f"dot_probe: p (mk, kk) and g (nk, kk) of one kk, "
                         f"got {tuple(p.shape)} and {tuple(g.shape)}")
    if steps < 1:
        raise ValueError(f"dot_probe: steps must be >= 1, got {steps}")


def dot_probe_cuda(p: torch.Tensor, g: torch.Tensor,
                   steps: int) -> torch.Tensor:
    """Launch K8: contiguous p (mk, kk) and g (nk, kk) on one CUDA device,
    both float32 or both bfloat16. Returns out (mk, nk) float32. The launch
    is :func:`plan`'s: a cluster of CTAs per output tile, each holding its
    K slice of the tile's rows in shared memory for all the steps; it runs
    as planned or raises (a plan that does not fit, a cluster the card
    cannot place). Not differentiable: raises under autograd."""
    check_operands("dot_probe", p, g)
    check_probe(p, g, steps)
    (mk, kk), nk = p.shape, g.shape[0]
    return launch_plan(p, g, steps, plan(mk, nk, kk, p.dtype))


def launch_plan(p: torch.Tensor, g: torch.Tensor, steps: int,
                pl: Plan) -> torch.Tensor:
    """K8's launch with plan `pl` (checked operands); counts the launch."""
    (mk, kk), nk = p.shape, g.shape[0]
    out = torch.empty((mk, nk), dtype=torch.float32, device=p.device)
    launch("vct_dot_probe", p.device, p.data_ptr(), g.data_ptr(),
           out.data_ptr(), mk, nk, kk, steps, DTYPE_CODES[p.dtype], pl.tn,
           pl.cluster, pl.kslice)
    dot_probe_cuda.launches += 1
    return out


dot_probe_cuda.launches = 0


def dot_probe_reference(p: torch.Tensor, g: torch.Tensor,
                        steps: int) -> torch.Tensor:
    """Plain version of K8: a loop of ``acc = acc + p.float() @ g.float().T``
    over the steps. On the card the caller turns TF32 off
    (``common.resolve_device``)."""
    check_probe(p, g, steps)
    pf, gt = p.float(), g.float().T
    acc = torch.zeros((p.shape[0], g.shape[0]), dtype=torch.float32,
                      device=p.device)
    for _ in range(steps):
        acc = acc + pf @ gt
    return acc


def make(mk: int, nk: int, kk: int, steps: int) -> Callable:
    """The probe's function for p (mk, kk) and g (nk, kk): K8 on CUDA
    tensors, the plain version on the CPU."""

    def f(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if tuple(p.shape) != (mk, kk) or tuple(g.shape) != (nk, kk):
            raise ValueError(f"dot_probe made for p {(mk, kk)} and g "
                             f"{(nk, kk)}, got {tuple(p.shape)} and "
                             f"{tuple(g.shape)}")
        if p.device.type == "cuda":
            return dot_probe_cuda(p, g, steps)
        return dot_probe_reference(p, g, steps)

    return f


def sweep(device: torch.device, shapes=SHAPES) -> List[dict]:
    """Every launch of :func:`candidates` with clusters of 1 to MAX_CLUSTER
    at each probe, bf16 all-ones operands: exact or not, ms per call, and
    the clusters the card places at once. The data behind :func:`plan`'s
    rule (PERF.md, §6). The card only: raises on another device."""
    if device.type != "cuda":
        raise RuntimeError("dot_probe sweep: launch plans are timed on a "
                           "CUDA device only")
    b16, rows = torch.bfloat16, []
    for name, mk, nk, kk, steps in shapes:
        p = torch.ones((mk, kk), dtype=b16, device=device)
        g = torch.ones((nk, kk), dtype=b16, device=device)
        chosen = plan(mk, nk, kk, b16)
        for pl in candidates(mk, nk, kk, b16, range(1, MAX_CLUSTER + 1)):
            exact = bool((launch_plan(p, g, steps, pl) == steps * kk).all())
            ms = median_ms(lambda: launch_plan(p, g, steps, pl), device, 3)
            row = {"name": name, **pl._asdict(), "waves": waves(pl),
                   "resident": resident(pl, kk, b16)[1], "exact": exact,
                   "ms": ms, "planned": pl == chosen}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv: Optional[List[str]] = None, shapes=SHAPES) -> List[dict]:
    """Each probe on all-ones bf16 operands: its time, and its result against
    the plain version (exact: every sum is an integer below 2^24). Returns
    one dict per probe, with ``calls``, the number of probe calls it made.
    ``--sweep`` (the card only) times every launch plan instead
    (:func:`sweep`)."""
    args = parse_args(argv, "K8, the dw dot probe (dw_dot_probe)",
                      flags=("--sweep",))
    device = resolve_device(args.device)
    print(f"device={device}", flush=True)
    if args.sweep:
        return sweep(device, shapes)
    results = []
    for name, mk, nk, kk, steps in shapes:
        p = torch.ones((mk, kk), dtype=torch.bfloat16, device=device)
        g = torch.ones((nk, kk), dtype=torch.bfloat16, device=device)
        f = make(mk, nk, kk, steps)
        calls = [0]

        def run():
            calls[0] += 1
            return f(p, g)

        got = run()
        err = float((got - dot_probe_reference(p, g, steps)).abs().max())
        dt = median_ms(run, device, ITERS)
        print(f"{name:34s} M={mk:4d} N={nk:4d} K={kk:5d} x{steps}: "
              f"{ms_text(dt)} err={err:g}", flush=True)
        results.append({"name": name, "p": (mk, kk), "g": (nk, kk),
                        "steps": steps, "err": err, "ms": dt,
                        "calls": calls[0]})
    return results


if __name__ == "__main__":
    main()
