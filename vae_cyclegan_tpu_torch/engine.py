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
syncs. The JAX engine's mesh and shard_map (data parallelism) have no
counterpart yet. The engine runs on ``task.device``: the card by default,
and a task there raises without CUDA.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vae_cyclegan_tpu_torch.data.device_aug import augment_batch
from vae_cyclegan_tpu_torch.models.tasks.base import Task

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


def noise_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of a validation batch's noise generator, from (seed, epoch,
    batch index) by explicit arithmetic."""
    return ((seed * 1_000_003 + epoch) * 1_000_003 + index) & 0x7FFFFFFF


class Engine:
    """Owns the device placement of batches, their on-device preparation
    and the epoch loops of one task.

    ``seed`` seeds the generator the training steps draw their noise from
    and, with the epoch and the batch index, each validation batch's.
    """

    def __init__(self, task: Task, seed: int = 0):
        self.task = task
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

    def train_step(self, batch: Dict[str, torch.Tensor],
                   eps: Optional[List] = None) -> Dict[str, torch.Tensor]:
        return self.task.train_step(self._prep(batch), eps=eps,
                                    generator=self.generator)

    def eval_step(self, batch: Dict[str, torch.Tensor],
                  eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        return self.task.eval_step(self._prep(batch), eps=eps,
                                   generator=generator)

    def generate(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 eps=None) -> torch.Tensor:
        return self.task.generate(self._prep(batch), generator=generator,
                                  eps=eps)

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
        (after the step); returning True ends the epoch early with the
        partial averages. `eps(i)`: the noise of step i, where the caller
        injects it. `epoch` is accepted for the JAX engine's signature.
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
                metrics = self.train_step(
                    device_batch, eps=None if eps is None else eps(n_batches))
                tc = time.perf_counter()
                nxt = next(_it, None)
                host += time.perf_counter() - tc
                h2d_wait += tb - ta
                dispatch += tc - tb
                put_fut = (put_pool.submit(self._put, nxt)
                           if nxt is not None else None)
                n_batches += 1
                n_images += next(iter(batch.values())).shape[0]
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
        last_Gx = last_Fy = last_x = last_y = None
        it = tqdm(loader, desc="Validation") if progress else loader
        for batch in it:
            device_batch = self._put(batch)
            gen = torch.Generator(self.device).manual_seed(
                noise_seed(self.seed, epoch, n_batches))
            metrics = dict(self.eval_step(
                device_batch, eps=None if eps is None else eps(n_batches),
                generator=gen))
            last_Gx = metrics.pop("Gx")
            last_Fy = metrics.pop("Fy", None)
            # raw (on-device-aug) batches have no host-side x/y images
            last_x = device_batch.get("x")
            last_y = device_batch.get("y")
            n_batches += 1
            for k, v in metrics.items():
                metric_sums[k] = v if k not in metric_sums else metric_sums[k] + v
        if n_batches == 0:
            return float("nan"), {}, None, None, None, None
        avg = self._means(metric_sums, n_batches)
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
        """One host fetch of every metric sum, as means over n batches."""
        keys = list(sums)
        fetched = torch.stack([sums[k].float() for k in keys]).cpu().tolist()
        return {k: float(v) / n for k, v in zip(keys, fetched)}
