"""Data-parallel training traffic: the closed loop of ``drivers/train.py``
on every rank of a one-host group of the cell's ``chips`` ranks, as
``train.py --num_devices N`` trains: one process a device, a
``torch.distributed`` group joined through ``parallel.mesh.make_group``
(NCCL on the card, gloo on the CPU), each rank's ``DataLoader`` taking its
shard of every global batch of ``batch_size`` (``shard_index`` /
``shard_count``, a batch the ranks do not divide given whole to every
rank), its own ``num_workers`` worker processes, and an ``Engine`` over the
group, whose steps mean the loss and gradients across the ranks
(``parallel.dp``).

This process is rank 0: it writes the data tree, starts ranks 1..N-1 as
fresh processes (start method ``spawn``), and drives them. Before every
``train_epoch`` call it broadcasts what the ranks run (which loader, the
epoch's augmentation streams, whether the epoch polls a stop) over the
group's gloo side (``mesh.cpu_group``); after every step the ranks agree on
stopping as ``train.py`` does (``utils.preempt.AgreedStop``), rank 0's
clock, or its trace, deciding. So the set-up's three one-step epochs, the
window and the traced spans run on every rank at once, and rank 0 alone
times and profiles. ``train_images_per_s`` is the global batch's images
(a replicated batch counted once) over rank 0's wall clock.

After set-up rank 0 gathers every rank's indices of the three compared
batches; the reference then repeats the three steps on the global batches
in float32 on rank 0's device, the generator step in blocks of the per-rank
batch (``reference/blocked.py``): each block's mean losses scaled by its
share and the gradients summed, each variational pass's noise drawn for the
whole global batch in pass order (``parallel.dp.dp_normal``'s draw) and
each discriminator call's power iteration made once. A rank that exits
with an error ends the run at once (exit code 3), as does rank 0's exit
for the others.
"""

from __future__ import annotations

import gc
import math
import os
import threading
import time
import torch
import torch.distributed as dist

from portbench.drivers import train as single
from portbench.harness import sub_seed
from portbench.reference import blocked
from portbench.reference.nets import F32, Precision

#: what rank 0 broadcasts before an epoch: the main loader, the main
#: loader with its first batch's indices kept (a compared step), the
#: remainder batch's loader; or the gather of the kept indices, or the end
MAIN, CHECK, REST, INDICES, EXIT = 0, 1, 2, 3, -1


def _watch(alive, die) -> None:
    """A daemon thread that polls `alive()` every second and calls
    `die()` once it is False."""

    def loop():
        while alive():
            time.sleep(1.0)
        die()

    threading.Thread(target=loop, daemon=True).start()


class _Asked:
    """A ``GracefulShutdown``-like flag whose ``requested`` is `fn()`."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def requested(self) -> bool:
        return bool(self.fn())


class _Rank:
    """One rank's loaders, task and engine, and the epochs it runs."""

    def __init__(self, cell: dict, cfg: dict, seed: int, device, base,
                 rank: int, world: int):
        from vae_cyclegan_tpu_torch.data import DataLoader, Subset
        from vae_cyclegan_tpu_torch.engine import Engine

        p = cell["params"]
        self.dataset = single._Keyed(base, seed)
        shard = dict(num_workers=p["num_workers"], shard_index=rank,
                     shard_count=world, ragged="replicate")
        self.loader = single._Counting(DataLoader(
            self.dataset, p["batch_size"], shuffle=True, seed=seed, **shard))
        rest = len(self.dataset) % p["batch_size"]
        self.rest = (single._Counting(DataLoader(
            Subset(self.dataset, range(rest)), rest, **shard))
            if rest else None)
        self.task = single.build_task(cfg, seed, device)
        self.engine = Engine(self.task, seed=sub_seed(seed, 2),
                             group=dist.group.WORLD)
        self.kept = []

    def epoch(self, kind: int, epoch: int, stop):
        """One ``train_epoch`` call of `kind` on the streams of `epoch`;
        `stop` None runs the whole epoch, else the ranks agree on it after
        every step."""
        from vae_cyclegan_tpu_torch.parallel import mesh
        from vae_cyclegan_tpu_torch.utils.preempt import AgreedStop

        loader = self.rest if kind == REST else self.loader
        self.dataset.epoch = epoch
        loader.indices.clear()
        agreed = (None if stop is None
                  else AgreedStop(_Asked(stop), mesh.cpu_group()))
        out = self.engine.train_epoch(loader, progress=False,
                                      should_stop=agreed)
        if kind == CHECK:
            self.kept.append(loader.indices[0])
        return out

    def close(self) -> None:
        self.loader.close()
        if self.rest is not None:
            self.rest.close()


def _command(values=None):
    """Rank 0 broadcasts `values` (kind, epoch, polls a stop); the other
    ranks pass None and get them."""
    from vae_cyclegan_tpu_torch.parallel import mesh

    t = torch.tensor(values or [0, 0, 0], dtype=torch.int64)
    dist.broadcast(t, src=0, group=mesh.cpu_group())
    return t.tolist()


def _follower(rank: int, world: int, init: str, device_type: str,
              cell: dict, cfg: dict, seed: int, base) -> None:
    """Rank `rank` (> 0): joins the group, then runs what rank 0
    broadcasts until it says the end."""
    from vae_cyclegan_tpu_torch.parallel import mesh

    parent = os.getppid()
    _watch(lambda: os.getppid() == parent, lambda: os._exit(1))
    dev = mesh.make_group(world, device_type, rank, init)
    me = None
    try:
        me = _Rank(cell, cfg, seed, dev, base, rank, world)
        while True:
            kind, epoch, polls = _command()
            if kind == EXIT:
                break
            if kind == INDICES:
                dist.all_gather_object([None] * world, me.kept,
                                       group=mesh.cpu_group())
                continue
            me.epoch(kind, epoch, (lambda: False) if polls else None)
    finally:
        if me is not None:
            me.close()
        mesh.destroy()


class Cell(single.Cell):
    """The data-parallel cell; its interface is ``drivers/train.py``'s."""

    def _block(self) -> int:
        """The samples of a block of the reference's generator step: one
        rank's share of the global batch."""
        return max(1, self.p["batch_size"] // self.cell["chips"])

    # -- set-up -------------------------------------------------------------

    def _start_ranks(self) -> None:
        import torch.multiprocessing as mp

        from vae_cyclegan_tpu_torch.parallel import mesh

        self.world = self.cell["chips"]
        init = f"tcp://127.0.0.1:{mesh.free_port()}"
        ctx = mp.get_context("spawn")
        kind = self.device.type
        self.procs = [ctx.Process(target=_follower, args=(
            r, self.world, init, kind, self.cell, self.cfg, self.seed,
            self.dataset.base)) for r in range(1, self.world)]
        for proc in self.procs:
            proc.start()
        self.ranks_up = True

        def failed():
            bad = [p.exitcode for p in self.procs
                   if p.exitcode not in (None, 0)]
            return bool(bad) and self.ranks_up

        def die():
            if self.ranks_up:
                self.log("portbench: a rank exited with an error; stopping")
                os._exit(3)

        _watch(lambda: not failed() and self.ranks_up, die)
        self.device = mesh.make_group(self.world, kind, 0, init)

    def _epoch(self, loader, should_stop=None, kind: int = MAIN):
        """One ``train_epoch`` call on every rank: the command, then rank
        0's own call, its `should_stop` agreed by the ranks."""
        _command([kind, self.epochs, int(should_stop is not None)])
        self.epochs += 1
        return self.me.epoch(kind, self.epochs - 1, should_stop)

    def setup(self) -> None:
        t = time.perf_counter()
        self.dataset = self._dataset()
        self.epochs = 0
        self.log(f"set-up: data tree {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        self._start_ranks()
        self.me = _Rank(self.cell, self.cfg, self.seed, self.device,
                        self.dataset.base, 0, self.world)
        self.dataset = self.me.dataset
        self.loader, self.task = self.me.loader, self.me.task
        self.engine = self.me.engine
        self.replicated = self.loader.replicated_batches()
        self.log(f"set-up: {self.world} ranks, task "
                 f"{time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        losses = []
        for step in range(single.CHECK_STEPS):
            _, avg, _ = self._epoch(self.loader, lambda: True, CHECK)
            losses.append((avg.get("G_loss", math.nan),
                           avg.get("D_loss", math.nan)))
            if step == 0:
                self.program.update(self._first_grads(), metrics=avg)
        self.program["losses"] = losses
        self.program["change"] = self._changes()
        from vae_cyclegan_tpu_torch.parallel import mesh

        _command([INDICES, 0, 0])
        ranks = [None] * self.world
        dist.all_gather_object(ranks, self.me.kept, group=mesh.cpu_group())
        self.check_indices = [sum((r[k] for r in ranks), [])
                              for k in range(single.CHECK_STEPS)]
        self.log(f"set-up: {single.CHECK_STEPS} first steps "
                 f"{time.perf_counter() - t:.2f} s")
        if self.me.rest is not None:
            self._epoch(self.me.rest, None, REST)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- window -------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        steps = images = 0
        host = h2d = nan = 0.0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            ran = [0]

            def stop():
                ran[0] += 1
                return time.perf_counter() >= deadline

            _, avg, _ = self._epoch(self.loader, stop)
            n = ran[0]
            ph = self.engine.epoch_phases
            steps += n
            images += sum(len(idx) * (1 if rep else self.world)
                          for idx, rep in zip(self.loader.indices[:n],
                                              self.replicated))
            host += ph["host_ms_per_batch"] * n
            h2d += ph["h2d_wait_ms_per_batch"] * n
            nan += avg.get("nan_detected", 0.0) * n
            if time.perf_counter() >= deadline:
                break
        if cuda:
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.log(f"window: {steps} steps, {images} images over "
                 f"{self.world} ranks in {elapsed:.4f} s")
        return {"attempted": steps, "failed": int(round(nan)),
                "images_per_s": images / elapsed,
                "s_per_unit": elapsed / steps,
                "metrics": {"train_images_per_s": images / elapsed},
                "host_ms_per_batch": host / steps,
                "h2d_wait_ms_per_batch": h2d / steps,
                "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if cuda else 0)}

    # -- the comparison -----------------------------------------------------

    def release(self) -> None:
        """The end broadcast, every rank leaving the group at once (as
        ``mesh.spawn``'s ranks do), then the ranks joined."""
        from vae_cyclegan_tpu_torch.parallel import mesh

        t = time.perf_counter()
        _command([EXIT, 0, 0])
        self.ranks_up = False
        self.me.close()
        mesh.destroy()
        for proc in self.procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
        del self.engine, self.task, self.loader, self.me
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.log(f"released {self.world} ranks in "
                 f"{time.perf_counter() - t:.2f} s")

    def reference(self, prec: Precision = F32, fault: str = None) -> dict:
        """``drivers/train.py``'s reference on the global batches, each
        family's step taken in blocks of one rank's share (module
        docstring): that driver builds its family by the name ``family``
        of its module, which is swapped for the call."""
        make = single.family

        def blocked_family(*a, **k):
            fam = make(*a, **k)
            fam.step = lambda x, y, gen: blocked.step(
                fam, x, y, gen, self._block(),
                blocked.DataParallel(fam, len(x)))
            return fam

        t = time.perf_counter()
        single.family = blocked_family
        try:
            return super().reference(prec, fault)
        finally:
            single.family = make
            self.log(f"reference: {time.perf_counter() - t:.2f} s")
