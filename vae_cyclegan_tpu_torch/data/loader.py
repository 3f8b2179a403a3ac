"""Batched, prefetching host loader.

Replaces torch DataLoader worker processes (train.py:221-237) with a
producer thread that assembles each batch and a bounded prefetch queue, so
the next batch is always being built while the current one trains. Where a
batch's samples are built is chosen from the samples (the first one, drawn
when the loader is made), and ``use_processes`` forces either path:

  * raw frames for on-card augmentation (the ``*_raw`` / ``*_aug`` wire of
    ``data.device_aug``) are built by threads of the training process. Their
    work is a copy out of the decode cache's shared memory; a pipe would
    copy each batch (113 MB at 1024x768, batch 24) twice more.
  * every other sample is decoded and augmented on the host: flip, crop,
    bicubic resize and colour jitter in Pillow and numpy, much of it holding
    the interpreter lock, which the thread that dispatches the step must win
    back after every torch call. These are built in worker processes.

The two needs conflict: for host-augmented samples the lock costs more than
the pipe, for raw frames the pipe costs more than the lock.

The worker processes are one pool per process (``_POOL``), shared by every
loader of it (training, validation, a remainder ``Subset``). They are
spawned, not forked (the process that trains has threads: the engine's copy
thread, the CUDA runtime's), when the first loader that needs them is made,
so that they import while the task is built; they close at exit
(``close_pool``) and never touch CUDA. Each epoch pickles the dataset once,
as it stands when the epoch starts, with the attached decode cache's path
(a generation); each task carries it, and a worker loads it once a
generation: a sample is drawn from the same state as on threads. A batch
goes to the workers as one task per worker, its contiguous share of the
batch, stacked there; the shares come back in sample order. So the training process's work a batch is
O(workers), not O(samples).

Randomness: the loader owns one `random.Random` per epoch seeded by
(base_seed, epoch); each example access gets a child Random seeded by
(epoch_seed, index-position) so results are reproducible regardless of
thread or process scheduling: both paths give the same batches, byte for
byte.

Counterpart of ``vae_cyclegan_tpu/data/loader.py``: the same seeds give the
same batches, byte for byte. Three differences: where a batch is built
(above; the JAX package builds in threads unless told, and forks its pool);
there is no ``device_put`` hook (the engine's ``_put`` places batches); and
sharded loaders take a rule for a global batch the shards do not divide
(``ragged``):

  * ``"drop"`` (the default; JAX's multi-host rule, ``--multihost``): the
    batch size must divide ``shard_count``, and a partial final batch is
    dropped on every rank;
  * ``"replicate"`` (JAX's single-host rule, ``--num_devices``): a global
    batch that divides ``shard_count`` is split into equal contiguous
    shards, and one that does not is given whole to every rank, with one
    warning (``parallel.mesh.shard_rows``); ``replicated_batches()`` says
    which batches of an epoch those are, for the engine.

While a profiler records, each batch's fetch is a ``vct.load_batch`` range
on its timeline with the arg ``processes`` (1 or 0), and each batch queued
counts as ``loader_batches.processes`` or ``loader_batches.threads`` in the
record of the next unit (``utils.spans``).
"""

from __future__ import annotations

import itertools
import multiprocessing
import multiprocessing.util
import os
import pickle
import queue
import random
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from vae_cyclegan_tpu_torch.utils import spans

#: the span counter of a queued batch, by whether processes built it
_COUNTERS = ("loader_batches.threads", "loader_batches.processes")


def _sample_rng(epoch_seed: int, pos: int) -> random.Random:
    return random.Random((epoch_seed * 1_000_003 + pos) & 0x7FFFFFFF)


def _stack(items: Sequence[dict]) -> Dict[str, np.ndarray]:
    """One array per key of the samples whose value is an array."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]
            if isinstance(items[0][k], np.ndarray)}


def _shares(pairs: list, n: int) -> List[list]:
    """`pairs` cut into at most `n` contiguous shares, in order, whose
    sizes differ by at most one."""
    n = min(n, len(pairs))
    size, extra = divmod(len(pairs), n)
    out, lo = [], 0
    for i in range(n):
        hi = lo + size + (i < extra)
        out.append(pairs[lo:hi])
        lo = hi
    return out


def _state(dataset) -> bytes:
    """The dataset as it stands, with the attached decode cache's path (a
    spawned worker starts with no cache)."""
    from vae_cyclegan_tpu_torch.data import datasets

    cache = datasets._DECODE_CACHE
    return pickle.dumps(
        (dataset, None if cache is None else str(cache.cache_path)),
        pickle.HIGHEST_PROTOCOL)


# -- in a worker process -----------------------------------------------------
#: the generation of the dataset this worker holds, and that dataset
_HELD: list = [None, None]


def _worker_init() -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _load(blob: bytes):
    """The dataset of a `_state` blob, its decode cache attached here."""
    from vae_cyclegan_tpu_torch.data import datasets
    from vae_cyclegan_tpu_torch.data.cache import DecodedImageCache

    dataset, cache_path = pickle.loads(blob)
    held = datasets._DECODE_CACHE
    if cache_path is None:
        datasets.set_decode_cache(None)
    elif held is None or str(held.cache_path) != cache_path:
        try:
            DecodedImageCache(cache_path).attach()
        except FileNotFoundError:  # removed since it was attached there: its
            datasets.set_decode_cache(None)  # images decode as misses do
    return dataset


def _warm(blob: bytes) -> None:
    _load(blob)


def _build_share(gen: int, blob: bytes, epoch_seed: int,
                 share: Sequence[Tuple[int, int]]) -> Dict[str, np.ndarray]:
    """The stacked samples of one share of a batch, each (global position,
    index), from the dataset of generation `gen` (loaded from `blob` once)."""
    if _HELD[0] != gen:
        _HELD[:] = [gen, _load(blob)]
    dataset = _HELD[1]
    return _stack([dataset.get(idx, _sample_rng(epoch_seed, pos))
                   for pos, idx in share])


# -- in the training process -------------------------------------------------
class _Pool:
    """The worker processes of this process, shared by every loader of
    the process, and the numbers of its datasets' generations."""

    def __init__(self):
        self._lock = threading.Lock()
        self._executor: Optional[ProcessPoolExecutor] = None
        self._size = 0
        self.generations = itertools.count()

    def executor(self, workers: int) -> ProcessPoolExecutor:
        """The pool, with at least `workers` processes: a smaller one is
        replaced, and finishes the tasks it was given."""
        with self._lock:
            if self._executor is None or self._size < workers:
                if self._executor is not None:
                    self._executor.shutdown(wait=False)
                self._executor = ProcessPoolExecutor(
                    workers, mp_context=multiprocessing.get_context("spawn"),
                    initializer=_worker_init)
                self._size = workers
            return self._executor

    def start(self, workers: int, blob: bytes) -> list:
        """Spawn the workers now, each loading `blob` once (its imports):
        one task a worker; the futures."""
        ex = self.executor(workers)
        return [ex.submit(_warm, blob) for _ in range(workers)]

    def close(self) -> None:
        with self._lock:
            ex, self._executor, self._size = self._executor, None, 0
        if ex is not None:
            ex.shutdown()


_POOL = _Pool()
# at exit, in a process multiprocessing started too (a data-parallel rank,
# which runs no atexit hook): before multiprocessing closes its queues
# (their finalizers have priority 10) and joins the process's children,
# which would otherwise wait for the idle workers for ever
multiprocessing.util.Finalize(None, _POOL.close, exitpriority=100)


def close_pool() -> None:
    """Stop this process's worker processes (at exit, or between tests); a
    loader that builds in processes starts them again."""
    _POOL.close()


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
        use_processes: Optional[bool] = None,
        shard_index: int = 0,
        shard_count: int = 1,
        ragged: str = "drop",
    ):
        """shard_index/shard_count: data parallelism over processes —
        every process builds the SAME global batch order (same seed/epoch)
        and takes its contiguous slice of each global batch, so the slices
        of one step make up one consistent global batch. `ragged`: "drop"
        or "replicate" (the module docstring). `use_processes`: None
        builds raw frames in threads and other samples in worker processes
        (the module docstring); True or False forces processes or threads.
        `num_workers`: the threads, or the shares of a batch in
        processes."""
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
        if ragged == "drop" and batch_size % shard_count != 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by shard_count "
                f"{shard_count}"
            )
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.epoch = 0
        if use_processes is None:
            use_processes = len(dataset) > 0 and not any(
                k.endswith("_raw") for k in dataset.get(0, random.Random(0)))
        #: whether batches are built in worker processes
        self.in_processes = bool(use_processes)
        self._starting = (_POOL.start(self.num_workers, _state(dataset))
                          if self.in_processes else [])

    def close(self) -> None:
        """Nothing of the loader's own to release: the worker processes
        are the process's (``close_pool``)."""

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

    def _drain_batches(self, batches, build, out_q, stop) -> None:
        processes = int(self.in_processes)
        for pos_idx_pairs in batches:
            if stop.is_set():
                return
            with spans.timeline("vct.load_batch", processes=processes):
                batch = build(pos_idx_pairs)
            if not self._put_stopaware(out_q, batch, stop):
                return
            spans.count(_COUNTERS[processes])

    def _drain_in_processes(self, batches, epoch_seed, out_q, stop) -> None:
        for f in self._starting:  # a worker that cannot load says so here
            f.result()
        self._starting = []
        gen, blob = next(_POOL.generations), _state(self.dataset)

        def build(pos_idx_pairs):
            ex = _POOL.executor(self.num_workers)
            futures = [ex.submit(_build_share, gen, blob, epoch_seed, share)
                       for share in _shares(pos_idx_pairs, self.num_workers)]
            parts = [f.result() for f in futures]
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}

        self._drain_batches(batches, build, out_q, stop)

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

            rows = [shard_rows(len(b), self.shard_index, self.shard_count)
                    for b in batches]
            batches = [b[lo:hi] for b, (lo, hi) in zip(batches, rows)]
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
            return self.dataset.get(idx, _sample_rng(epoch_seed, pos))

        def producer():
            try:
                if self.in_processes:
                    self._drain_in_processes(batches, epoch_seed, out_q, stop)
                else:
                    with ThreadPoolExecutor(self.num_workers) as tpool:
                        self._drain_batches(
                            batches,
                            lambda pairs: _stack(list(tpool.map(fetch_one,
                                                                pairs))),
                            out_q, stop)
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
