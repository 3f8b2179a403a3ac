"""Batched, prefetching host loader.

Replaces torch DataLoader worker processes (train.py:221-237) with a
thread-pool decode stage plus a bounded prefetch queue: PIL decode releases
the GIL, so threads overlap decode/augment with the device's step, and the
next batch is always being assembled while the current one trains.

Randomness: the loader owns one `random.Random` per epoch seeded by
(base_seed, epoch); each example access gets a child Random seeded by
(epoch_seed, index-position) so results are reproducible regardless of
thread scheduling.

Counterpart of ``vae_cyclegan_tpu/data/loader.py``, the same code: the
same seeds give the same batches, byte for byte. Three differences: the
process pool starts its workers with ``spawn``, not ``fork`` (the process
that trains has threads: the engine's copy thread, the CUDA runtime's), and
hands each worker the attached decode cache's path to attach again; and
there is no ``device_put`` hook (the engine's ``_put`` places batches);
and sharded loaders take a rule for a global batch the shards do not divide
(``ragged``):

  * ``"drop"`` (the default; JAX's multi-host rule, ``--multihost``): the
    batch size must divide ``shard_count``, and a partial final batch is
    dropped on every rank;
  * ``"replicate"`` (JAX's single-host rule, ``--num_devices``): a global
    batch that divides ``shard_count`` is split into equal contiguous
    shards, and one that does not is given whole to every rank, with one
    warning (``parallel.mesh.shard_rows``); ``replicated_batches()`` says
    which batches of an epoch those are, for the engine.
"""

from __future__ import annotations

import multiprocessing
import queue
import random
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

# -- process-worker plumbing -------------------------------------------------
# Each worker process holds the dataset once (sent via initializer) and
# fetches items by (position, index, epoch_seed); only the decoded arrays
# cross the IPC boundary.
_WORKER_DATASET = None


def _process_init(dataset, cache_path=None) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    if cache_path is not None:  # a spawned worker starts with no cache
        from vae_cyclegan_tpu_torch.data.cache import DecodedImageCache

        DecodedImageCache(cache_path).attach()


def _process_fetch(args):
    pos, idx, epoch_seed = args
    rng = random.Random((epoch_seed * 1_000_003 + pos) & 0x7FFFFFFF)
    return _WORKER_DATASET.get(idx, rng)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = False,
        prefetch: int = 2,
        use_processes: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
        ragged: str = "drop",
    ):
        """shard_index/shard_count: data parallelism over processes —
        every process builds the SAME global batch order (same seed/epoch)
        and takes its contiguous slice of each global batch, so the slices
        of one step make up one consistent global batch. `ragged`: "drop"
        or "replicate" (the module docstring)."""
        if ragged not in ("drop", "replicate"):
            raise ValueError(f"ragged must be 'drop' or 'replicate', got "
                             f"{ragged!r}")
        self.ragged = ragged
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.use_processes = use_processes
        if ragged == "drop" and batch_size % shard_count != 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by shard_count "
                f"{shard_count}"
            )
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.epoch = 0
        self._pool = None  # lazily-built persistent process pool

    def _process_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            from vae_cyclegan_tpu_torch.data import datasets

            cache = datasets._DECODE_CACHE
            self._pool = ProcessPoolExecutor(
                self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_process_init,
                initargs=(self.dataset,
                          None if cache is None else cache.cache_path),
            )
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def replicated_batches(self):
        """Per batch of an epoch, whether every rank gets it whole (the
        "replicate" rule, a global batch the shards do not divide); the
        same every epoch: shuffling moves samples, not batch sizes."""
        n = len(self.dataset)
        sizes = [min(self.batch_size, n - i)
                 for i in range(0, n, self.batch_size)]
        if self.drop_last or (self.shard_count > 1 and self.ragged == "drop"):
            sizes = [b for b in sizes if b == self.batch_size]
        return [self.shard_count > 1 and b % self.shard_count != 0
                for b in sizes]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @staticmethod
    def _put_stopaware(out_q, item, stop) -> bool:
        """Enqueue unless/until the consumer signalled stop. A plain
        blocking put can deadlock a daemon producer forever when the
        consumer abandons the iterator while the queue is full."""
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _drain_batches(self, batches, run_batch, out_q, stop) -> None:
        for pos_idx_pairs in batches:
            if stop.is_set():
                return
            items = run_batch(pos_idx_pairs)
            batch = {
                k: np.stack([it[k] for it in items])
                for k in items[0]
                if isinstance(items[0][k], np.ndarray)
            }
            if not self._put_stopaware(out_q, batch, stop):
                return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = list(range(n))
        # explicit arithmetic (not hash()) so every host in a multi-host run
        # derives the identical epoch seed regardless of interpreter details
        epoch_seed = (self.seed * 2_654_435_761 + self.epoch * 40_503) & 0x7FFFFFFF
        if self.shuffle:
            random.Random(epoch_seed).shuffle(order)

        batches = [
            order[i : i + self.batch_size]
            for i in range(0, n, self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        # attach GLOBAL positions (the augmentation RNG key), so shards of
        # the same global batch draw the same per-example augmentations as
        # a single-host run would
        pos = 0
        positioned = []
        for b in batches:
            positioned.append([(pos + j, ix) for j, ix in enumerate(b)])
            pos += len(b)
        batches = positioned
        if self.shard_count > 1 and self.ragged == "replicate":
            from vae_cyclegan_tpu_torch.parallel.mesh import shard_rows

            spans = [shard_rows(len(b), self.shard_index, self.shard_count)
                     for b in batches]
            batches = [b[lo:hi] for b, (lo, hi) in zip(batches, spans)]
        elif self.shard_count > 1:
            # every host slices the same global batch; partial final batches
            # are dropped (they can't be split evenly across hosts)
            batches = [b for b in batches if len(b) == self.batch_size]
            local = self.batch_size // self.shard_count
            lo = self.shard_index * local
            batches = [b[lo : lo + local] for b in batches]

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def fetch_one(pos_idx):
            pos, idx = pos_idx
            rng = random.Random((epoch_seed * 1_000_003 + pos) & 0x7FFFFFFF)
            return self.dataset.get(idx, rng)

        def producer():
            try:
                if self.use_processes:
                    pool = self._process_pool()

                    def run_batch(pos_idx_pairs):
                        return list(pool.map(
                            _process_fetch,
                            [(p, ix, epoch_seed) for p, ix in pos_idx_pairs],
                        ))
                    self._drain_batches(batches, run_batch, out_q, stop)
                else:
                    with ThreadPoolExecutor(self.num_workers) as tpool:
                        def run_batch(pos_idx_pairs):
                            return list(tpool.map(fetch_one, pos_idx_pairs))
                        self._drain_batches(batches, run_batch, out_q, stop)
                self._put_stopaware(out_q, None, stop)
            except BaseException as e:  # surface worker errors to consumer
                self._put_stopaware(out_q, e, stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit promptly
            while not out_q.empty():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            # partial iterations still advance the epoch (reshuffle next time)
            self.epoch += 1
