"""Spans and counters inside the training step and the request.

On exactly while a ``torch.profiler`` session records (``on()``): the
operator turns them on by profiling, e.g. ``train.py --profile_dir``; there
is no flag of their own. Off, a site costs one read of the profiler's flag;
the waits of ``Engine.epoch_phases`` (``wait``) keep their two clock reads,
which they always took.

While on:

  * every span and wait opens a range on the profiler's timeline, the clock
    its device activity uses (a ``cpu_op`` event named ``vct.<name>``,
    whose args, where the session records shapes, carry ``unit``, the
    unit's index, and ``key``);
  * a unit (``unit``: ``vct.step``, one ``Engine.train_step``, or
    ``vct.request``, one ``run_inference``) keeps a record in memory,
    ``units()``, in order and bounded: its wall time, the dispatching
    threads' CPU time (the calling thread's, and during ``vct.backward`` the
    autograd engine's device thread, which runs a CUDA backward), the
    process's CPU time, each span opened inside it with its parent, the
    waits of its loop iteration (``Engine.train_epoch``: the copy wait
    before the step, the loader wait after it), what ``count`` counted
    since the unit before (the loader's batches, by where they were built)
    and, per ``vct::`` operator, the calls made through ``op`` and their
    host ns from call to return;
  * ``timeline`` opens a range and keeps nothing (the copy thread, the
    loader's producer).

Spans and units are opened on one thread, the one that dispatches the
step; ``op`` is called on it or, in a backward, on the autograd engine's
thread while that thread waits in ``torch.autograd.grad``; ``count`` on
any thread.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

#: the units kept, the newest last
MAX_UNITS = 4096

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def on() -> bool:
        """Whether a ``torch.profiler`` session records now."""
        return _autograd_profiler._is_profiler_enabled
else:  # pragma: no cover - torch without the Python-side flag
    on = torch._C._autograd._profiler_enabled


def _range(name: str, **args):
    """A range on the profiler's timeline, a context to enter; its args
    those of `args` that are not None."""
    return torch._C._profiler._RecordFunctionFast(
        name, [], {k: v for k, v in args.items() if v is not None})


#: what a site gets while no session records
_OFF = contextlib.nullcontext()


class _Unit:
    """The record of one unit while it is open."""

    def __init__(self, name: str, index: int):
        self.name, self.index = name, index
        self.key: Optional[str] = None
        self.spans: List[dict] = []
        self.stack: List[int] = []
        self.waits: List[dict] = []
        self.ops: Dict[str, List[int]] = {}
        self.counts: Dict[str, int] = {}
        #: the autograd engine's CPU ns inside the unit's backward spans
        self.worker_ns = 0

    def record(self, start_ns: int, wall_ns: int, cpu_ns: int,
               process_ns: int) -> dict:
        return {"name": self.name, "index": self.index, "start_ns": start_ns,
                "wall_ns": wall_ns, "cpu_ns": cpu_ns + self.worker_ns,
                "process_ns": process_ns, "spans": self.spans,
                "waits": self.waits, "counts": self.counts,
                "ops": {k: {"calls": c, "ns": ns}
                        for k, (c, ns) in self.ops.items()}}


class _State:
    """The records of this process: the open unit, the units kept, the waits
    and counts that belong to the next unit."""

    def __init__(self):
        #: guards ``counts``, which any thread adds to
        self.lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.current: Optional[_Unit] = None
        self.units: deque = deque(maxlen=MAX_UNITS)
        self.pending: List[dict] = []
        self.counts: Dict[str, int] = {}
        self.count = 0


_STATE = _State()


def units() -> List[dict]:
    """The records of the units kept, oldest first. Each: ``name``,
    ``index`` (its position among the units recorded since ``reset``),
    ``start_ns`` (``time.perf_counter_ns``), ``wall_ns``, ``cpu_ns`` (the
    dispatching threads'), ``process_ns``, ``spans`` (each ``name``,
    ``key``, ``parent``: the index in ``spans`` of the span it lies in, or
    None directly inside the unit, ``start_ns``, ``wall_ns``, ``cpu_ns``),
    ``waits`` (each ``name``, ``start_ns``, ``wall_ns``), ``counts``
    (``{name: n}``, what ``count`` counted before the unit opened) and ``ops``
    (``{"vct::<op>": {"calls", "ns"}}``)."""
    return list(_STATE.units)


def reset() -> None:
    """Forget every record (tests)."""
    _STATE.reset()


class _Root:
    """``unit``'s context while on."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _STATE
        self.unit = u = _Unit(self.name, st.count)
        st.count += 1
        u.waits, st.pending = st.pending, []
        with st.lock:
            u.counts, st.counts = st.counts, {}
        st.current = u
        self.rf = _range(self.name, unit=u.index)
        self.rf.__enter__()
        self.p0 = time.process_time_ns()
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        c1 = time.thread_time_ns()
        p1 = time.process_time_ns()
        self.rf.__exit__(None, None, None)
        st = _STATE
        st.current = None
        st.units.append(self.unit.record(self.t0, t1 - self.t0,
                                         c1 - self.c0, p1 - self.p0))


def unit(name: str):
    """The context of one unit (``vct.step``, ``vct.request``): while on,
    its range and its record (module docstring)."""
    if not on():
        return _OFF
    return _Root(name)


class _Span:
    """``span``'s context while on."""

    def __init__(self, name: str, key: Optional[str], grad_of):
        self.name, self.key, self.grad_of = name, key, grad_of

    def _first_node(self, grad_outputs) -> None:
        # the first node of the backward, on the thread that runs it
        self.worker = (threading.get_ident(), time.thread_time_ns())

    def __enter__(self):
        u = self.unit = _STATE.current
        if u is not None:
            if self.key is None:
                self.key = u.key
            u.key = self.key
        self.rf = _range(self.name, unit=None if u is None else u.index,
                         key=self.key)
        self.rf.__enter__()
        if u is None:
            return self
        self.worker = self.hook = None
        fn = getattr(self.grad_of, "grad_fn", None)
        if fn is not None:
            self.hook = fn.register_prehook(self._first_node)
        self.i = len(u.spans)
        u.spans.append({"name": self.name, "key": self.key,
                        "parent": u.stack[-1] if u.stack else None})
        u.stack.append(self.i)
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        u = self.unit
        if u is None:
            self.rf.__exit__(None, None, None)
            return
        t1 = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self.c0
        if self.hook is not None:
            self.hook.remove()
        if self.worker is not None and self.worker[0] != threading.get_ident():
            ident, w0 = self.worker
            w = time.clock_gettime_ns(time.pthread_getcpuclockid(ident)) - w0
            cpu += w
            u.worker_ns += w
        self.rf.__exit__(None, None, None)
        u.stack.pop()
        u.spans[self.i].update(start_ns=self.t0, wall_ns=t1 - self.t0,
                               cpu_ns=cpu)


def span(name: str, key: Optional[str] = None, grad_of=None):
    """The context of one span: while on, its range, and inside a unit its
    record. `key` (the optimizer's, ``G`` / ``D`` / ``optimizer``) is kept
    with it; a span given none takes the last key given in its unit.
    `grad_of`: the tensor whose backward the span runs, so that the
    autograd engine's thread is timed from its first node."""
    if not on():
        return _OFF
    return _Span(name, key, grad_of)


def timeline(name: str, **args):
    """A range on the profiler's timeline while on, with `args`; no
    record."""
    return _range(name, **args) if on() else _OFF


def count(name: str) -> None:
    """While on, one more `name` in the ``counts`` of the next unit to
    open; from any thread (the loader's producer)."""
    if not on():
        return
    st = _STATE
    with st.lock:
        st.counts[name] = st.counts.get(name, 0) + 1


class wait:
    """A wait of the epoch loop, always timed (``start_ns``, ``end_ns``,
    ``ns``). While on, also a range, and a record kept in the unit it
    belongs to: `belongs` "next" (the copy wait before the step), "last"
    (the loader wait after it, in the unit just closed) or None (none)."""

    def __init__(self, name: str, belongs: Optional[str] = None):
        self.name, self.belongs = name, belongs

    def __enter__(self):
        self.rf = _range(self.name) if on() else None
        if self.rf is not None:
            self.rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        self.ns = self.end_ns - self.start_ns
        if self.rf is None:
            return
        self.rf.__exit__(None, None, None)
        rec = {"name": self.name, "start_ns": self.start_ns,
               "wall_ns": self.ns}
        st = _STATE
        if self.belongs == "next":
            st.pending.append(rec)
        elif self.belongs == "last" and st.units:
            st.units[-1]["waits"].append(rec)


def op(fn: Callable, *args):
    """``fn(*args)``, a ``vct::`` custom operator; while on and inside a
    unit, the call is counted in the unit's ``ops`` with its host ns."""
    u = _STATE.current if on() else None
    if u is None:
        return fn(*args)
    t0 = time.perf_counter_ns()
    out = fn(*args)
    ns = time.perf_counter_ns() - t0
    # no lock: the op's caller is the dispatching thread or, in a backward,
    # the autograd engine's thread while the dispatching one waits for it
    slot = u.ops.setdefault(fn._qualname, [0, 0])
    slot[0] += 1
    slot[1] += ns
    return out
