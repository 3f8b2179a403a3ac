"""The data-parallel step: the gradient mean and globally placed noise.

Counterpart of ``vae_cyclegan_tpu/parallel/dp.py``. There the whole step
runs under ``jax.shard_map`` over the 'data' axis, so every kernel sees the
shard-local shapes it was written for, and the one cross-device fact of
data parallelism, the gradient mean, is one explicit ``pmean``. Here each
rank of a process group (``parallel.mesh``) runs the eager step on its own
shard, so K1-K4 see the same shard-local shapes, and the mean is one
``all_reduce``.

Mechanics. The engine opens ``dp_scope(group)`` around a step (the JAX
engine sets its scope around the shard_map body). Inside it:

  * ``sync`` means a list of tensors across the group: one flattened f32
    buffer, one ``all_reduce`` (sum, then divided by the group's size).
    ``Task._finite_update`` calls it on (loss, gradients) before it reads
    the loss's finiteness, so every rank takes the same branch, and a NaN
    on one rank skips the update on all; the engine calls it on the
    metrics. The port takes its gradients with ``torch.autograd.grad``,
    which never fills ``.grad``, so ``DistributedDataParallel``'s hooks
    would not fire: the mean is taken here, by hand.
  * ``dp_normal`` draws the global batch's noise from a generator seeded
    alike on every rank and keeps this rank's rows, so a rank gets the
    values the one-process step draws for its batch positions, bit for bit.
  * ``gather`` concatenates a per-rank batch output in rank order (JAX's
    ``out_specs=P('data')``).

A replicated scope (``dp_scope(group, replicated=True)``: a batch that does
not divide the group, given whole to every rank, ``mesh.shard_rows``) draws
the noise unsliced and gathers nothing; the mean still runs, and keeps the
ranks' parameters equal. Outside a scope all three are no-ops. The port
needs no ``eps_queue``: its steps take their noise as arguments.

NCCL runs a blocking collective on its own stream and makes the current
(compute) stream wait for it, so the loss read after ``sync`` sees the
reduced value.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class _Scope:
    group: object
    world: int
    rank: int
    replicated: bool


_SCOPE: ContextVar[Optional[_Scope]] = ContextVar("vct_torch_dp_scope",
                                                  default=None)


@contextlib.contextmanager
def dp_scope(group=None, replicated: bool = False):
    """Mark a data-parallel step over `group` (the default group when
    None); `replicated` where every rank holds the whole batch."""
    group = dist.group.WORLD if group is None else group
    token = _SCOPE.set(_Scope(group, dist.get_world_size(group),
                              dist.get_rank(group), replicated))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def dp_group():
    """The active scope's process group, or None outside a scope."""
    scope = _SCOPE.get()
    return None if scope is None else scope.group


def sync(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The cross-rank means of `tensors` (their shapes and dtypes; f32
    tensors come back as views of one buffer): one flattened f32 buffer and
    one all_reduce. Outside a scope, the tensors themselves. Per-rank means
    of equal shards mean to the global batch's mean, and a NaN on any rank
    reaches every rank."""
    scope = _SCOPE.get()
    tensors = list(tensors)
    if scope is None or not tensors:
        return tensors
    buf = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=scope.group)
    if scope.world > 1:
        buf.div_(scope.world)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(buf[at:at + n].view(t.shape).to(t.dtype))
        at += n
    return out


def dp_normal(generator: Optional[torch.Generator], shape, device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``torch.randn(shape)`` that data parallelism leaves unchanged.
    Outside a scope, or in a replicated one: the plain draw. Inside: the
    global batch's noise, (B_local * world, ...), drawn from `generator`,
    and this rank's rows [rank * B_local, (rank + 1) * B_local), the values
    the one-process step draws for them."""
    scope = _SCOPE.get()
    shape = tuple(shape)
    if scope is None or scope.replicated or scope.world == 1:
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype)
    b = shape[0]
    g = torch.randn((b * scope.world, *shape[1:]), generator=generator,
                    device=device, dtype=dtype)
    return g[scope.rank * b:(scope.rank + 1) * b]


def gather(t: torch.Tensor) -> torch.Tensor:
    """A per-rank batch output concatenated along dim 0 in rank order (the
    global batch); outside a scope or in a replicated one, `t` itself."""
    scope = _SCOPE.get()
    if scope is None or scope.replicated or scope.world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(scope.world)]
    dist.all_gather(parts, t.contiguous(), group=scope.group)
    return torch.cat(parts)
