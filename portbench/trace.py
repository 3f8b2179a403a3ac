"""The profiled spans of a run and what the per-layer readers take from them.

``profile_span`` runs a callable under ``torch.profiler``, exports the
Chrome trace into the run's scratch directory, reads it back and deletes it.
A traced run takes two spans of the same length. The first records the
device activity alone (no host operators, no shapes), so the profiler adds
little host time per launch, and gives the busy time, the idle share, the
kernels, the copies and the breakdown. The second also records the host
operators with their input shapes, for what needs them: the kernels
launched inside named operator ranges, matched through the launch's
correlation id and thread, with the operator's shapes (the starved conv's
roofline). A session whose trace holds no device activity (CUPTI now and
then hands back an empty buffer) is run again, up to ``TRIES`` times; after
that the span is not measured.

The span's wall time is taken on the host clock between ``Control.open``
(after the profiler started, with the device idle) and ``Control.close``
(after a device synchronise, before the profiler stops), so every device
interval of the trace lies inside it.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

TRIES = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint sorted intervals covering `intervals` (start, end)."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Span:
    """One traced span, times in seconds."""

    def __init__(self, events: List[dict], units: int, window_s: float,
                 ops_of_interest=("vct::starved_conv",)):
        self.units, self.window_s = units, window_s
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.device = sorted((e["name"], e["cat"], e["ts"] * 1e-6,
                              e["dur"] * 1e-6) for e in dev)
        self.kernels = [d for d in self.device if d[1] == "kernel"]
        self.copies = [d for d in self.device if d[1] == "gpu_memcpy"]
        self.busy = union([(t, t + d) for _, _, t, d in self.device])
        self.busy_s = sum(b - a for a, b in self.busy)
        self._calls = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                              e["name"]) for e in events
                             if e.get("cat") in LAUNCH_CATS and "dur" in e)
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation"
                    in e.get("args", {})}
        self.op_kernels: Dict[str, List[Tuple[dict, float]]] = defaultdict(list)
        ranges: Dict[Tuple, List[dict]] = defaultdict(list)
        for e in events:
            if (e.get("cat") == "cpu_op" and "dur" in e
                    and e["name"] in ops_of_interest):
                ranges[(e["pid"], e["tid"])].append(e)
        for r in ranges.values():
            r.sort(key=lambda e: e["ts"])
        starts = {k: [e["ts"] for e in r] for k, r in ranges.items()}
        for e in dev:
            if e.get("cat") != "kernel" or not ranges:
                continue
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is None:
                continue
            key = (launch["pid"], launch["tid"])
            i = bisect.bisect_right(starts.get(key, []), launch["ts"]) - 1
            if i >= 0:
                op = ranges[key][i]
                if launch["ts"] <= op["ts"] + op["dur"]:
                    self.op_kernels[op["name"]].append((op, e["dur"] * 1e-6))

    def op_device(self, name: str) -> Dict[int, Tuple[dict, float]]:
        """Per CPU operator range of `name` (by its id), (the op's event,
        the device seconds of the kernels launched inside it)."""
        out: Dict[int, list] = {}
        for op, sec in self.op_kernels.get(name, []):
            slot = out.setdefault(id(op), [op, 0.0])
            slot[1] += sec
        return {k: (v[0], v[1]) for k, v in out.items()}

    def device_ops(self, top: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, _, _, dur in self.device:
            total[name[:120]] += dur
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest gaps between busy intervals, each named by what the
        host was doing when it opened: the CUDA runtime or driver call in
        progress then, or, outside any, the device operation whose launch
        ended the gap."""
        if not self.busy:
            return []
        starts = [d[2] for d in self.device]
        ends = [c[0] for c in self._calls]
        gaps = sorted(((b2[0] - b1[1], b1[1], b2[0]) for b1, b2
                       in zip(self.busy, self.busy[1:])), reverse=True)
        out = []
        for length, at, until in gaps[:top]:
            i = bisect.bisect_right(ends, at) - 1
            if i >= 0 and self._calls[i][1] >= at:
                name = f"host in {self._calls[i][2]}"
            else:
                nxt = self.device[min(bisect.bisect_left(starts, until),
                                      len(self.device) - 1)][0]
                name = f"host outside CUDA calls, before {nxt}"
            out.append([name[:120], length])
        return out


class Control:
    """The span's start and end, which a driver calls between steps or
    requests: ``open`` starts the profiler, ``close`` synchronises the
    device and stops it; the wall time between them on the host clock."""

    def __init__(self, prof: torch.profiler.profile):
        self.prof, self.window_s = prof, 0.0

    def open(self) -> None:
        self.prof.start()
        self._t0 = time.perf_counter()

    def close(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()


def profile_span(run: Callable[[Control], int], scratch: Path, log=print,
                 with_ops: bool = False) -> Optional[Span]:
    """`run(control)` opens `control` at the span's start, closes it at
    its end and returns the span's units (steps or requests). The device
    activity alone, or with `with_ops` also the host operators and their
    input shapes; None where no session of ``TRIES`` recorded device
    activity."""
    acts = ({torch.profiler.ProfilerActivity.CUDA}
            if torch.cuda.is_available() else set())
    if with_ops or not acts:
        acts.add(torch.profiler.ProfilerActivity.CPU)
    for attempt in range(TRIES):
        control = Control(torch.profiler.profile(activities=list(acts),
                                                 record_shapes=with_ops))
        units = run(control)
        path = scratch / f"trace{attempt}.json"
        control.prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        span = Span(events, units, control.window_s)
        if span.kernels:
            return span
        log(f"profiler: a session of {units} units recorded no device "
            "activity; again")
    return None
