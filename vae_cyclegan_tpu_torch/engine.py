"""Generic epoch engine: one epoch loop trains all ten architectures.

Counterpart of ``vae_cyclegan_tpu/engine.py`` as an eager loop over the
port's stateful ``Task`` (the task holds its weights and optimizers, so no
state is threaded). It replaces the reference's train_epoch/validate
(train.py:80-128, 131-171) and keeps the JAX engine's design:

  * batches cross to the device as they come from the loader: uint8 stays
    uint8 over PCIe (4x fewer bytes than f32), through pinned host memory
    and a copy stream; ``_prep`` then augments raw wire-format batches on
    the card (``data.device_aug``) and turns uint8 into f32 / 255;
  * dispatch first: step i runs before batch i+1's copy is issued, and the
    copy runs in a side thread;
  * metrics stay on the device as 0-d tensors, summed there, and are
    fetched once per epoch (the reference calls ``.item()`` per metric per
    step, Networks.py:2054-2073).

The task itself still reads its loss on the host once per optimizer (the
finite-loss guard, ``models/tasks/base.py``), so a step is not free of
syncs. The engine runs on ``task.device``: the card by default, and a task
there raises without CUDA.

Data parallelism (JAX's shard_map over a 'data' mesh): ``Engine(task,
seed, group)`` with a process group (``parallel.mesh``) runs each step on
this rank's shard under ``parallel.dp.dp_scope``, so the task means (loss,
gradients) across the ranks in its finite gate and draws its noise as the
global batch's rows. Each step's metrics are meaned across the ranks (one
small all_reduce, JAX's pmean of the metrics); ``eval_step``'s and
``generate``'s images are gathered to the global batch in rank order.
Batches are the rank's shards (the loader's ``shard_index`` /
``shard_count``); a batch given whole to every rank (a global batch that
does not divide the group, ``parallel.mesh.shard_rows``) runs replicated:
``replicated=True``, which the epoch loops read from the loader's
``replicated_batches()``. Spatial parallelism (ROADMAP.md queue 1, item
7c) has no counterpart yet.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vae_cyclegan_tpu_torch.data.device_aug import augment_batch
from vae_cyclegan_tpu_torch.models.tasks.base import Task
from vae_cyclegan_tpu_torch.parallel import dp

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    def tqdm(it, **kw):
        return it

#: per-step injected noise: batch index -> the step's eps list (NHWC), or
#: None to draw it
EpsFn = Callable[[int], Optional[List]]


def _normalize_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: (v.to(torch.float32) / 255.0 if v.dtype == torch.uint8 else v)
            for k, v in batch.items()}


def _to_float_image(t: torch.Tensor) -> np.ndarray:
    """A device image batch as f32 numpy (uint8 / 255; bf16 widened)."""
    if t.dtype == torch.uint8:
        return t.cpu().numpy().astype(np.float32) / 255.0
    return t.detach().float().cpu().numpy()


def _replicated_batches(loader) -> Callable[[int], bool]:
    """Batch index -> whether the loader gives that batch whole to every
    rank (``DataLoader.replicated_batches``); a loader without the method
    yields shards only."""
    flags = getattr(loader, "replicated_batches", None)
    flags = flags() if flags is not None else []
    return lambda i: i < len(flags) and bool(flags[i])


def noise_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of a validation batch's noise generator, from (seed, epoch,
    batch index) by explicit arithmetic."""
    return ((seed * 1_000_003 + epoch) * 1_000_003 + index) & 0x7FFFFFFF


class Engine:
    """Owns the device placement of batches, their on-device preparation
    and the epoch loops of one task.

    ``seed`` seeds the generator the training steps draw their noise from
    and, with the epoch and the batch index, each validation batch's; every
    rank of `group` seeds them alike. `group`: a ``torch.distributed``
    process group to run data-parallel over, or None for the plain step.
    """

    def __init__(self, task: Task, seed: int = 0, group=None):
        self.task = task
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.device = task.device
        self.out_size = task.mc.image_size
        self.seed = seed
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._cuda = self.device.type == "cuda"
        self.epoch_phases: Dict[str, float] = {}
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._compute_stream = torch.cuda.current_stream(self.device)

    # -- placement and preparation ------------------------------------------

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> device tensors, dtype kept (uint8 stays uint8). On
        the card: pinned host memory, a non-blocking copy on the engine's
        copy stream, waited for before returning, so the tensors are ready
        for the compute stream."""
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not self._cuda:
            return {k: v.to(self.device) for k, v in host.items()}
        with torch.cuda.stream(self._copy_stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
        self._copy_stream.synchronize()
        for t in out.values():  # allocated on the copy stream, used here
            t.record_stream(self._compute_stream)
        return out

    def _prep(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """On the device: raw frames augmented, uint8 -> f32 / 255 (the
        task's ``_nchw`` casts without dividing)."""
        return _normalize_batch(augment_batch(batch, self.out_size))

    # -- steps ----------------------------------------------------------------

    def _scope(self, replicated: bool):
        """The data-parallel scope of one step (none without a group)."""
        if self.group is None:
            return contextlib.nullcontext()
        return dp.dp_scope(self.group, replicated)

    @staticmethod
    def _mean(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The metrics meaned across the ranks (within a scope)."""
        return dict(zip(metrics, dp.sync(list(metrics.values()))))

    def train_step(self, batch: Dict[str, torch.Tensor],
                   eps: Optional[List] = None,
                   replicated: bool = False) -> Dict[str, torch.Tensor]:
        """One step on this rank's shard `batch` (`eps`: its noise, this
        rank's rows); `replicated` where the batch is the whole global
        batch on every rank."""
        with self._scope(replicated):
            return self._mean(self.task.train_step(
                self._prep(batch), eps=eps, generator=self.generator))

    def eval_step(self, batch: Dict[str, torch.Tensor],
                  eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None,
                  replicated: bool = False) -> Dict[str, torch.Tensor]:
        with self._scope(replicated):
            m = dict(self.task.eval_step(self._prep(batch), eps=eps,
                                         generator=generator))
            images = {k: dp.gather(m.pop(k)) for k in ("Gx", "Fy") if k in m}
            return {**self._mean(m), **images}

    def generate(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 eps=None, replicated: bool = False) -> torch.Tensor:
        with self._scope(replicated):
            return dp.gather(self.task.generate(
                self._prep(batch), generator=generator, eps=eps))

    # -- epochs ---------------------------------------------------------------

    def train_epoch(
        self,
        loader,
        progress: bool = True,
        epoch: Optional[int] = None,
        should_stop=None,
        eps: Optional[EpsFn] = None,
    ) -> Tuple[float, Dict[str, float], Any]:
        """Returns (avg_G_loss, avg_metric_components, last_batch).

        `should_stop`: optional zero-arg callable polled once per step
        (after the step; in a group it must agree across the ranks, as
        ``utils.preempt.AgreedStop`` does); returning True ends the epoch
        early with the partial averages. `eps(i)`: the noise of step i,
        where the caller injects it. `epoch` is accepted for the JAX
        engine's signature.
        ``images_per_sec`` counts from the first batch's request to the
        metrics' fetch. ``self.epoch_phases`` then holds where the epoch's
        host time went, in ms: per batch blocked on the loader (``host``),
        on the copy (``h2d_wait``) and in the step call (``dispatch``: the
        task reads its loss, so most of the step), the metrics' fetch
        (``final_sync``) and the whole epoch per batch (``window``).
        """
        metric_sums: Dict[str, torch.Tensor] = {}
        n_batches = 0
        last_batch = None
        it = tqdm(loader, desc="Training") if progress else loader
        t0 = time.perf_counter()
        n_images = 0
        # Lagged per-step loss display (reference train.py:107 shows
        # pbar.set_postfix per step): keep recent G_loss tensors with an
        # event recorded after each, and show the newest one whose event
        # has completed (query() never blocks), at most twice a second.
        show_loss = progress and hasattr(it, "set_postfix")
        pending_losses: deque = deque(maxlen=64)
        next_loss_poll = t0 + 0.5
        # One-batch-ahead device prefetch, dispatch first: step i runs
        # before batch i+1's copy is issued, and the copy runs in a side
        # thread.
        put_pool = ThreadPoolExecutor(1)
        host = h2d_wait = dispatch = 0.0
        replicated = _replicated_batches(loader)
        try:
            _it = iter(it)
            batch = next(_it, None)
            host += time.perf_counter() - t0
            put_fut = (put_pool.submit(self._put, batch)
                       if batch is not None else None)
            while batch is not None:
                ta = time.perf_counter()
                device_batch = put_fut.result()
                tb = time.perf_counter()
                rep = replicated(n_batches)
                metrics = self.train_step(
                    device_batch, eps=None if eps is None else eps(n_batches),
                    replicated=rep)
                tc = time.perf_counter()
                nxt = next(_it, None)
                host += time.perf_counter() - tc
                h2d_wait += tb - ta
                dispatch += tc - tb
                put_fut = (put_pool.submit(self._put, nxt)
                           if nxt is not None else None)
                n_batches += 1
                n_images += next(iter(batch.values())).shape[0] * (
                    1 if rep else self.world)
                for k, v in metrics.items():
                    metric_sums[k] = (v if k not in metric_sums
                                      else metric_sums[k] + v)
                if show_loss and "G_loss" in metrics:
                    pending_losses.append((self._event(), metrics["G_loss"]))
                    now = time.perf_counter()
                    if now >= next_loss_poll:
                        next_loss_poll = now + 0.5
                        ready = None
                        while pending_losses and (
                                pending_losses[0][0] is None
                                or pending_losses[0][0].query()):
                            ready = pending_losses.popleft()[1]
                        if ready is not None:
                            it.set_postfix(loss=f"{float(ready):.4f}",
                                           refresh=False)
                last_batch = device_batch
                batch = nxt
                if should_stop is not None and should_stop():
                    break
        finally:
            put_pool.shutdown(wait=True)
        if n_batches == 0:
            return float("nan"), {}, None
        tsync = time.perf_counter()
        avg = self._means(metric_sums, n_batches)  # the epoch's one fetch
        tend = time.perf_counter()
        elapsed = tend - t0
        avg["images_per_sec"] = n_images / elapsed if elapsed > 0 else 0.0
        self.epoch_phases = {
            "host_ms_per_batch": 1000 * host / n_batches,
            "h2d_wait_ms_per_batch": 1000 * h2d_wait / n_batches,
            "dispatch_ms_per_batch": 1000 * dispatch / n_batches,
            "final_sync_ms": 1000 * (tend - tsync),
            "window_ms_per_batch": 1000 * elapsed / n_batches,
        }
        return avg.get("G_loss", float("nan")), avg, last_batch

    def validate(
        self,
        loader,
        progress: bool = True,
        epoch: int = 0,
        eps: Optional[EpsFn] = None,
    ) -> Tuple[float, Dict[str, float], Any, Any, Any, Any]:
        """Returns (avg_loss, avg_components, last_Gx, last_Fy, last_x,
        last_y), the images as NHWC f32 numpy arrays.

        Each batch's noise comes from a generator seeded with
        ``noise_seed(self.seed, epoch, batch index)``, so the metrics
        depend only on (seed, epoch), not on how many validate calls came
        before; `eps(i)` injects batch i's noise instead.
        """
        metric_sums: Dict[str, torch.Tensor] = {}
        n_batches = 0
        last_Gx = last_Fy = last_batch = None
        last_rep = False
        replicated = _replicated_batches(loader)
        it = tqdm(loader, desc="Validation") if progress else loader
        for batch in it:
            device_batch = self._put(batch)
            gen = torch.Generator(self.device).manual_seed(
                noise_seed(self.seed, epoch, n_batches))
            last_rep = replicated(n_batches)
            metrics = dict(self.eval_step(
                device_batch, eps=None if eps is None else eps(n_batches),
                generator=gen, replicated=last_rep))
            last_Gx = metrics.pop("Gx")
            last_Fy = metrics.pop("Fy", None)
            last_batch = device_batch
            n_batches += 1
            for k, v in metrics.items():
                metric_sums[k] = v if k not in metric_sums else metric_sums[k] + v
        if n_batches == 0:
            return float("nan"), {}, None, None, None, None
        avg = self._means(metric_sums, n_batches)
        # the last batch's x/y gathered as its Gx is (raw on-device-aug
        # batches have no host-side x/y images)
        with self._scope(last_rep):
            last_x, last_y = (
                dp.gather(last_batch[k]) if k in last_batch else None
                for k in ("x", "y"))
        return (
            avg.get("G_loss", float("nan")),
            avg,
            _to_float_image(last_Gx),
            _to_float_image(last_Fy) if last_Fy is not None else None,
            _to_float_image(last_x) if last_x is not None else None,
            _to_float_image(last_y) if last_y is not None else None,
        )

    # -- helpers --------------------------------------------------------------

    def _event(self) -> Optional[torch.cuda.Event]:
        """A CUDA event recorded on the compute stream, None on the CPU."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self._compute_stream)
        return ev

    @staticmethod
    def _means(sums: Dict[str, torch.Tensor], n: int) -> Dict[str, float]:
        """One host fetch of every metric sum, as means over n batches (in a
        group, sums of metrics each step already meaned across the
        ranks)."""
        keys = list(sums)
        fetched = torch.stack([sums[k].float() for k in keys]).cpu().tolist()
        return {k: float(v) / n for k, v in zip(keys, fetched)}
