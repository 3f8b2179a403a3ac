"""Per-layer metric readers, one file per metric named as in
``BENCHMARK.json`` (``<metric>.py``, each with ``read(ctx) -> float or
None``), and what several of them share. A reader that finds nothing to
read returns None and the harness leaves the metric out of the line."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Optional

from portbench import peaks

HERE = Path(__file__).resolve().parent


def reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def model_flops_percent(ctx, kind: str) -> Optional[float]:
    """100 x model FLOPs per image x the window's images per second over
    the bf16 peak."""
    rate = ctx.window.get("images_per_s")
    if not rate:
        return None
    return (100.0 * ctx.flops_per_image(kind) * rate
            / peaks.FLOPS_PER_S["bfloat16"])


def idle_percent(span) -> Optional[float]:
    if span is None or span.window_s <= 0:
        return None
    return 100.0 * (1.0 - span.busy_s / span.window_s)
