"""Spatial parallelism: image rows split over the ranks of a spatial group.

Counterpart of what GSPMD inserts for the JAX package's 2-D ('data',
'spatial') meshes (``vae_cyclegan_tpu/parallel/mesh.py``, ``engine.py``):
there the partitioner adds the convs' halo exchanges and the InstanceNorm
and loss moment all-reduces by itself, with every Pallas kernel off. Here
each rank of a spatial group holds rows [r H/S, (r + 1) H/S) of every image
of its data shard, every rank holds the parameters, and the model's ops ask
this module for the three things the rows alone cannot give:

  * ``halo(x, top, bottom)``: the `top` rows above this rank's rows and the
    `bottom` rows below them, from the neighbours, and at the image's true
    borders the reflect rows, built from the extended strip (own rows plus
    the neighbour's halo), so a one-row shard still reflects right;
  * ``spatial_sum(t)``: the sum of a per-rank partial over the group (the
    InstanceNorm moments, the discriminator's whole-map conv);
  * ``gather_rows(t, dim)``: a row-sharded output put back together.

The invariant that makes the gradient right. Every loss term on a rank is
either the local mean over its own equal-sized shard (L1, cycle, identity
and KL: every function of ``losses.py`` is a full-tensor mean) or the full
value of a replicated quantity (the discriminator's score, after its
``spatial_sum``). Every collective's backward is its adjoint: the backward
of an all-reduce sum is an all-reduce sum of the cotangents, and the
backward of a halo receive sends the halo's gradient back to the rank that
owns those rows, which adds it onto them. Then the sum over a spatial group
of each rank's autograd gradient is S times the gradient of the group's
loss, and the world mean of ``parallel.dp.sync`` (over data x spatial ranks)
is the mean over the data groups of their gradients: ``sync`` needs no
change. The InstanceNorm sites keep the same rule (``ops.instance_norm.
_InActSpatial``: their moments and their backward's two means are group
sums).

One mechanism for every backend: each exchange is an ``all_reduce`` (sum)
of a zeroed f32 buffer (f64 for f64 values) with one slot per rank, which
gloo takes on CPU and CUDA tensors and NCCL takes on the card (gloo's
send/recv and all_gather are CPU-only): the halos, the moment sums and
``gather_over``, which puts row shards (``gather_rows``) and data shards
(``parallel.dp.gather``) back together. A sum of one value and zeros is
exact, so the exchange moves the bits; bf16 values travel widened to f32.
The slots cost S times the halo's bytes; NCCL point-to-point is later
work.

A scope (``spatial_scope(layout)``) marks a step as spatial; outside one
nothing here runs. A scope of size 1 (``single()``, no process group) runs
the same formulas with no collective: ``BENCH_SPATIAL=1`` and the tests use
it to price and check the lowering on one device. A replicated scope (an
image height that does not divide the group, ``parallel.mesh.
shard_height``) carries the layout for the data-parallel helpers but turns
the row sharding off: every rank of the group computes the whole image.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Layout:
    """One rank's place in a (data x spatial) layout: the spatial group
    (adjacent ranks, ``parallel.mesh.make_spatial``) and the data group
    (the ranks that hold the same rows of other samples). A group is None
    where its size is 1."""

    size: int
    rank: int
    group: object
    data_size: int
    data_rank: int
    data_group: object


def single() -> Layout:
    """The layout of one process: a spatial group of 1, a data group of 1."""
    return Layout(1, 0, None, 1, 0, None)


_SCOPE: ContextVar[Optional[Tuple[Layout, bool]]] = ContextVar(
    "vct_torch_spatial_scope", default=None)


@contextlib.contextmanager
def spatial_scope(layout: Optional[Layout] = None, replicated: bool = False):
    """Mark a spatial step over `layout` (``single()`` when None);
    `replicated` where every rank of the group holds whole images."""
    token = _SCOPE.set((layout or single(), replicated))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def current() -> Optional[Layout]:
    """The active scope's layout where rows are sharded, else None (no
    scope, or a replicated one): what the model's ops read."""
    scope = _SCOPE.get()
    return None if scope is None or scope[1] else scope[0]


def layout() -> Optional[Layout]:
    """The active scope's layout, replicated or not (the data-parallel
    helpers read its data group), else None."""
    scope = _SCOPE.get()
    return None if scope is None else scope[0]


def spatial_size() -> int:
    """The active (row-sharded) scope's group size, 1 outside one."""
    lay = current()
    return 1 if lay is None else lay.size


def min_image_size(size: int) -> int:
    """The smallest image_size whose every level the spatial lowering takes
    at a group of `size`: the four 2x downsamplings need an even local
    height at each level, so H / (8 S) even, H a multiple of 16 S."""
    return 16 * size


def refuse(site: str, rows: int, need: str) -> None:
    """Raise for a site whose local rows the lowering cannot take (JAX's
    GSPMD can: it re-partitions); names the site and the smallest
    image_size that works."""
    s = spatial_size()
    raise ValueError(
        f"spatial parallelism: {site} has {rows} local row(s) at a spatial "
        f"group of {s} and needs {need}; GSPMD would re-partition here, the "
        f"port does not. Use --image_size a multiple of "
        f"{min_image_size(s)} (the smallest that works at --spatial {s} is "
        f"{min_image_size(s)}), or a smaller --spatial")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _slots(n: int, size: int, like: torch.Tensor) -> torch.Tensor:
    """A zeroed (size, n) buffer: f32, or f64 for f64 values."""
    dtype = torch.float64 if like.dtype == torch.float64 else torch.float32
    return torch.zeros((size, n), dtype=dtype, device=like.device)


def reduce_sum(t: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The sum over `lay`'s spatial group of an f32 tensor, not
    differentiable (the InstanceNorm Functions call it in their forward
    and backward); `t` itself at a group of 1."""
    if lay.size == 1:
        return t
    out = (t if t.dtype == torch.float64 else t.float()).contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=lay.group)
    return out


class _SpatialSum(torch.autograd.Function):
    """All-reduce sum; its backward all-reduce-sums the cotangents."""

    @staticmethod
    def forward(ctx, t, lay):
        ctx.lay = lay
        return reduce_sum(t, lay).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.lay).to(g.dtype), None


def spatial_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of a per-rank partial over the spatial group, differentiable
    (its backward is the adjoint: the cotangents' sum); `t` itself outside
    a row-sharded scope or at a group of 1."""
    lay = current()
    if lay is None or lay.size == 1:
        return t
    return _SpatialSum.apply(t, lay)


class _Halo(torch.autograd.Function):
    """(the `top` rows above this rank's, the `bottom` rows below), empty
    at the true borders. Each rank puts its last `top` rows and its first
    `bottom` rows in its slot of one buffer; the backward puts each halo's
    gradient in its owner's slot and the owner adds it onto those rows."""

    @staticmethod
    def forward(ctx, x, top, bottom, lay):
        n, c, h, w = x.shape
        a, b = n * c * top * w, n * c * bottom * w
        buf = _slots(a + b, lay.size, x)
        buf[lay.rank, :a] = x[:, :, h - top:].reshape(-1)
        buf[lay.rank, a:] = x[:, :, :bottom].reshape(-1)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=lay.group)
        up = (buf[lay.rank - 1, :a].view(n, c, top, w) if lay.rank > 0
              else buf.new_empty((n, c, 0, w)))
        dn = (buf[lay.rank + 1, a:].view(n, c, bottom, w)
              if lay.rank < lay.size - 1 else buf.new_empty((n, c, 0, w)))
        ctx.cfg = (x.shape, x.dtype, top, bottom, lay)
        return up.to(x.dtype), dn.to(x.dtype)

    @staticmethod
    def backward(ctx, g_up, g_dn):
        (n, c, h, w), dtype, top, bottom, lay = ctx.cfg
        a, b = n * c * top * w, n * c * bottom * w
        buf = _slots(a + b, lay.size, g_up)
        if lay.rank > 0:
            buf[lay.rank - 1, :a] = g_up.reshape(-1)
        if lay.rank < lay.size - 1:
            buf[lay.rank + 1, a:] = g_dn.reshape(-1)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=lay.group)
        dx = torch.zeros((n, c, h, w), dtype=buf.dtype, device=g_up.device)
        dx[:, :, h - top:] += buf[lay.rank, :a].view(n, c, top, w)
        dx[:, :, :bottom] += buf[lay.rank, a:].view(n, c, bottom, w)
        return dx.to(dtype), None, None, None


def halo(x: torch.Tensor, top: int, bottom: int,
         site: str = "a conv") -> torch.Tensor:
    """This rank's NCHW rows extended by `top` rows above and `bottom`
    below: the neighbours' rows inside the image, reflect rows at its true
    borders (from the extended strip). Differentiable. Outside a
    row-sharded scope, the reflect padding of the rows alone."""
    from vae_cyclegan_tpu_torch.ops.padding import reflect_rows

    lay = current() or single()
    h = x.shape[2]
    if lay.size > 1 and h < max(top, bottom):
        refuse(site, h, f"at least {max(top, bottom)} for its halo")
    if lay.size > 1:
        up, dn = _Halo.apply(x, top, bottom, lay)
        ext = torch.cat([up, x, dn], dim=2)
    else:
        ext = x
    return reflect_rows(ext, top if lay.rank == 0 else 0,
                        bottom if lay.rank == lay.size - 1 else 0)


def gather_over(t: torch.Tensor, size: int, rank: int, group,
                dim: int) -> torch.Tensor:
    """Every rank's `t` (rank `rank` of `size` over `group`) concatenated
    along `dim` in rank order, through one slot buffer's all_reduce (not
    differentiable); `t` itself where `size` is 1."""
    if size == 1:
        return t
    buf = _slots(t.numel(), size, t)
    buf[rank] = t.detach().reshape(-1)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    parts = [buf[r].view(t.shape).to(t.dtype) for r in range(size)]
    return torch.cat(parts, dim=dim)


def gather_rows(t: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """A row-sharded tensor's rows from every rank of the spatial group,
    concatenated along `dim` in rank order (not differentiable); `t` itself
    outside a row-sharded scope."""
    lay = current()
    if lay is None:
        return t
    return gather_over(t, lay.size, lay.rank, lay.group, dim)

