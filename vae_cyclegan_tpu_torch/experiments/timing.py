"""CUDA-event timing of the prototypes' calls.

The counterpart of ``experiments/pallas_conv_proto.py:91`` (``timeit``) and
``experiments/pallas_conv2.py:119`` / ``pallas_conv3.py:122``
(``timeit_scan``): warm up, then time ``windows`` windows of ``iters`` calls
each and take the median, in ms per call. The device is synchronized only at
the window edges, so a window measures back-to-back calls as the JAX loops
and scans do. A CPU run has no device time: it returns None ("not
measured").
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

WINDOWS = 5


def median_ms(fn: Callable[[], object], device: torch.device, iters: int,
              windows: int = WINDOWS, warmup: int = 2) -> Optional[float]:
    """Median over `windows` windows of the CUDA-event time of `iters`
    back-to-back calls of `fn`, per call, after `warmup` calls; None on a
    device other than CUDA."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times.sort()
    return times[len(times) // 2]


def ms_text(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms:7.3f}ms"
