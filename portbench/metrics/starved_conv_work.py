"""Operations and bytes of one call of ``vct::starved_conv`` (the starved
conv, forward or dx), from the input shapes the profiler recorded: x and the
weight read once, the output written once, 2 multiply-adds per tap and
channel (the counts of ``chip_smoke.py``'s ``conv_work``). The least time
is the larger of bytes at the HBM peak and operations at the compute peak
of the operands' dtype."""

from __future__ import annotations

import math
from typing import Optional

from portbench import peaks

_SIZES = {"c10::BFloat16": (2, "bfloat16"), "c10::Half": (2, "float16"),
          "float": (4, "float32")}


def least_seconds(op: dict) -> Optional[float]:
    """The least time of the call whose profiler event is `op`, or None
    where its shapes or dtype were not recorded."""
    args = op.get("args", {})
    dims, types = args.get("Input Dims"), args.get("Input type")
    if not dims or len(dims) < 2 or not types or types[0] not in _SIZES:
        return None
    (n, cin, h, w), (cout, _, k, _) = dims[0], dims[1]
    size, dtype = _SIZES[types[0]]
    concrete = args.get("Concrete Inputs") or []
    mode = concrete[2].strip("'\"") if len(concrete) > 2 else "reflect"
    oh, ow = (h + k - 1, w + k - 1) if mode == "zero" else (h, w)
    nbytes = (n * cin * h * w + cout * cin * k * k + n * cout * oh * ow) * size
    ops = 2.0 * n * oh * ow * cout * cin * k * k
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FLOPS_PER_S[dtype])


def roofline_percent(span) -> Optional[float]:
    """100 x the summed least times over the summed device times of the
    kernels launched inside the span's ``vct::starved_conv`` ranges; None
    where the span has none or a call's shapes are missing."""
    calls = list(span.op_device("vct::starved_conv").values()) if span else []
    if not calls:
        return None
    least = [least_seconds(op) for op, _ in calls]
    if any(t is None for t in least):
        return None
    device = sum(sec for _, sec in calls)
    return 100.0 * math.fsum(least) / device if device > 0 else None
