"""Data parallelism over a ``torch.distributed`` process group.

Counterpart of ``vae_cyclegan_tpu/parallel/mesh.py``. JAX runs one process
over N devices and goes multi-process only across hosts; PyTorch runs one
process per device at every scale. So N devices on one host and N hosts
are both a group of N ranks, each with one device: rank r of a one-host
group (``spawn``, ``make_group``) runs on ``cuda:r``, rank r of a
multi-host group (``init_from_env``, the environment ``torchrun`` sets) on
``cuda:LOCAL_RANK``. The backend is NCCL on the card and gloo on the CPU;
the rendezvous is a TCP store on the loopback address (one host) or at
``MASTER_ADDR:MASTER_PORT`` (``torchrun``). Parameters and optimizer states
are replicated: every rank builds them from the same seed (or loads the
same checkpoint), and the gradient mean (``parallel.dp``) keeps them equal.

Nothing falls back: asking for more CUDA devices than are visible raises,
as ``make_mesh`` does; a rank that cannot reach its device or the group
raises, and ``spawn`` then stops every rank.

The batch rule (``shard_rows``), JAX's single-host one: a global batch that
divides the group is split into equal contiguous shards, rank r taking rows
[r B/N, (r + 1) B/N); one that does not is given whole to every rank (each
computes the full batch, and the mean of their equal gradients leaves them
as they were up to rounding), with one ``RuntimeWarning`` worded as
``mesh.py``'s. The multi-host loader drops a partial final batch instead
(``data.loader``).

Spatial parallelism (``make_spatial``, JAX's ``make_mesh(n, spatial=S)``):
the N ranks form N/S data groups x S spatial ranks, adjacent ranks sharing
a spatial group (rank r is spatial rank r % S of data group r // S), so a
group's halo exchanges stay between neighbouring devices. Every rank
creates one process group per spatial group and one per data group (the
ranks with the same spatial index), all in the same order. The loader
shards by data rank and data size (the ranks of a spatial group read the
same samples), and the engine slices each image's rows by spatial rank
(``shard_height``: a height that does not divide S is replicated over the
group, with one warning worded as ``mesh.py``'s). As in JAX, spatial
sharding is one host's: ``--multihost`` with S > 1 raises.
"""

from __future__ import annotations

import os
import socket
import warnings
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from vae_cyclegan_tpu_torch.parallel.spatial import Layout, single

_warned_replicated_batch = False
_warned_replicated_spatial = False
_cpu_group = None


def backend_for(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def resolve_devices(n_devices: Optional[int], device) -> int:
    """The rank count of a one-host group on `device`'s type: `n_devices`,
    or every visible CUDA device when None (1 on the CPU). Raises if fewer
    CUDA devices are visible than asked for; the CPU hosts any count."""
    dev = torch.device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if dev.type != "cuda":
        return 1 if n_devices is None else n_devices
    have = torch.cuda.device_count()
    if have == 0:
        raise RuntimeError("no CUDA device is visible")
    if n_devices is None:
        return have
    if have < n_devices:
        raise RuntimeError(
            f"requested {n_devices} devices but only {have} CUDA device(s) "
            f"are visible; pass --num_devices {have} or fewer (or --platform "
            f"cpu for CPU ranks over gloo)")
    return n_devices


def _rank_device(device, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} has no device: "
            f"{torch.cuda.device_count()} CUDA device(s) visible")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def free_port() -> int:
    """A free TCP port on the loopback address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_group(n_devices: int, device, rank: int,
               init_method: str) -> torch.device:
    """Join rank `rank` of an `n_devices`-rank group on this host and return
    the rank's device (``cuda:rank``, or the CPU)."""
    n = resolve_devices(n_devices, device)
    dev = _rank_device(device, rank)
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            rank=rank, world_size=n)
    return dev


def init_from_env(device) -> torch.device:
    """Join the group ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and return the rank's
    device (``cuda:LOCAL_RANK``, or the CPU). Raises if a variable is
    missing."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    missing = [k for k in keys if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--multihost needs the launcher's environment ({', '.join(keys)}"
            f"; torchrun sets them): missing {', '.join(missing)}")
    dev = _rank_device(device, int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend_for(dev), init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def _rank_main(rank: int, fn: Callable, n: int, device: str,
               init_method: str, args: tuple) -> None:
    dev = make_group(n, device, rank, init_method)
    try:
        fn(dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n_devices: Optional[int], device, *args) -> int:
    """Run ``fn(rank_device, *args)`` in N fresh processes (start method
    ``spawn``), one a rank of a one-host group; returns N once every rank
    has returned. `fn` must be a module-level function. Raises before
    starting anything if the devices are too few, and if a rank raises
    (the others are then stopped). A SIGTERM to this process is passed on
    to every rank (``utils.preempt`` turns it into an agreed stop)."""
    import signal

    import torch.multiprocessing as mp

    n = resolve_devices(n_devices, device)
    init = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(
        _rank_main, args=(fn, n, str(torch.device(device).type), init, args),
        nprocs=n, join=False, start_method="spawn")

    def forward(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    # a terminal's SIGINT already reaches every rank (one process group)
    prev = {s: signal.signal(s, h) for s, h in
            ((signal.SIGTERM, forward), (signal.SIGINT, signal.SIG_IGN))}
    try:
        while not ctx.join():
            pass
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
    return n


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if initialized() else 1


def is_primary() -> bool:
    """Whether this process writes the run's files: rank 0, or no group."""
    return rank() == 0


def cpu_group():
    """A gloo group over the default group's ranks, for host-side flags
    that must not wait for the device (the NCCL group reduces on the
    card's stream); the default group itself where it is gloo."""
    global _cpu_group
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if _cpu_group is None:
        _cpu_group = dist.new_group(backend="gloo")
    return _cpu_group


def destroy() -> None:
    """Leave the default group, if any."""
    global _cpu_group
    if initialized():
        dist.destroy_process_group()
    _cpu_group = None


def shard_rows(rows: int, rank_: int, world: int,
               key: str = "batch") -> Tuple[int, int]:
    """[lo, hi) of rank `rank_`'s rows of a global batch of `rows`: equal
    contiguous shards where `world` divides `rows`, else every row (the
    batch replicated on every rank), with one RuntimeWarning."""
    global _warned_replicated_batch
    if rows % world == 0:
        local = rows // world
        return rank_ * local, (rank_ + 1) * local
    if not _warned_replicated_batch:
        _warned_replicated_batch = True
        warnings.warn(
            f"batch dim {rows} of '{key}' does not divide the {world}-rank "
            f"data group: the batch is REPLICATED on every rank and all data "
            f"parallelism is forfeited. Use --batch_size divisible by "
            f"{world} (e.g. {max(world, (rows + world - 1) // world * world)})"
            f".", RuntimeWarning, stacklevel=2)
    return 0, rows


def shard_batch(batch: Mapping, rank_: Optional[int] = None,
                world: Optional[int] = None) -> Tuple[Dict, bool]:
    """(this rank's part of a global host or device batch, whether the
    batch is replicated), by ``shard_rows``; the rank and size default to
    the default group's."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    key, first = next(iter(batch.items()))
    lo, hi = shard_rows(first.shape[0], rank_, world, key)
    return ({k: v[lo:hi] for k, v in batch.items()},
            hi - lo == first.shape[0] and world > 1)


def check_spatial(spatial: int, world: int, multihost: bool = False) -> None:
    """JAX's refusals of a spatial size (``make_mesh``, ``shard_batch``): a
    size below 1, a size that does not divide the `world` ranks, and
    spatial sharding across hosts."""
    if spatial < 1:
        raise ValueError(f"spatial must be >= 1, got {spatial}")
    if multihost and spatial > 1:
        raise NotImplementedError(
            "spatial sharding is single-host (ICI) only; use a pure "
            "data-parallel mesh across hosts")
    if world % spatial:
        raise ValueError(f"spatial axis size {spatial} does not divide the "
                         f"{world}-device mesh")


def make_spatial(spatial: int, multihost: bool = False) -> Layout:
    """This rank's (data x spatial) layout over the default group (or one
    process's ``single()`` without a group, where `spatial` must be 1):
    N / S data groups of S adjacent ranks. Every rank calls it, at the same
    point: it creates every group, in the same order. Raises as
    ``check_spatial``."""
    world, r = world_size(), rank()
    check_spatial(spatial, world, multihost)
    if not initialized():
        return single()
    data = world // spatial
    spatial_groups = [dist.new_group(list(range(d * spatial,
                                                (d + 1) * spatial)))
                      for d in range(data)]
    data_groups = [dist.new_group(list(range(s, world, spatial)))
                   for s in range(spatial)]
    return Layout(spatial, r % spatial,
                  spatial_groups[r // spatial] if spatial > 1 else None,
                  data, r // spatial,
                  data_groups[r % spatial] if data > 1 else None)


def shard_height(rows: int, s_rank: int, size: int,
                 key: str = "x") -> Tuple[int, int]:
    """[lo, hi) of spatial rank `s_rank`'s rows of an image height `rows`:
    equal contiguous shards where `size` divides it, else every row (the
    image replicated over the group), with one RuntimeWarning worded as
    ``mesh.py``'s."""
    global _warned_replicated_spatial
    if rows % size == 0:
        local = rows // size
        return s_rank * local, (s_rank + 1) * local
    if not _warned_replicated_spatial:
        _warned_replicated_spatial = True
        warnings.warn(
            f"dim 1 (height) of '{key}' ({rows}) does not divide the "
            f"{size}-device spatial axis: '{key}' is replicated over "
            f"'spatial' and spatial parallelism is forfeited for it.",
            RuntimeWarning, stacklevel=2)
    return 0, rows


def shard_spatial(batch: Mapping, lay: Layout) -> Tuple[Dict, bool]:
    """(this spatial rank's rows of the NHWC images of a device batch,
    whether they are replicated over the spatial group), by
    ``shard_height`` on the first image's height; tensors of other ranks
    pass whole."""
    key, first = next((k, v) for k, v in batch.items() if v.dim() == 4)
    lo, hi = shard_height(first.shape[1], lay.rank, lay.size, key)
    return ({k: v[:, lo:hi] if v.dim() == 4 else v
             for k, v in batch.items()},
            hi - lo == first.shape[1] and lay.size > 1)
