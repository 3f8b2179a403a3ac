"""What the readers of the program's own spans share: the units the
program recorded while the traced spans profiled it
(``vae_cyclegan_tpu_torch.utils.spans``, on only while a profiler records).

``units(ctx, name)`` takes the first ``ctx.span.units`` units of `name`
(``vct.step`` or ``vct.request``): ``trace()`` runs the span of the device
activity first, so these are the steps or requests the device-trace
metrics read. None where there is no span, where fewer units were
recorded, or where the program has no span module."""

from __future__ import annotations

import importlib
import statistics
from typing import Callable, List, Optional


def units(ctx, name: str) -> Optional[List[dict]]:
    if ctx.span is None or not ctx.span.units:
        return None
    try:
        spans = importlib.import_module("vae_cyclegan_tpu_torch.utils.spans")
    except ImportError:
        return None
    got = [u for u in spans.units() if u["name"] == name][:ctx.span.units]
    return got if len(got) == ctx.span.units else None


def wall_ns(unit: dict, name: str) -> int:
    """The summed wall ns of the unit's spans named `name`."""
    return sum(s["wall_ns"] for s in unit["spans"] if s["name"] == name)


def median(ctx, name: str, value: Callable[[dict], Optional[float]]):
    """The median of `value(unit)` over the units (those it gives a value
    for), or None."""
    got = units(ctx, name)
    if got is None:
        return None
    values = [v for v in map(value, got) if v is not None]
    return statistics.median(values) if values else None
