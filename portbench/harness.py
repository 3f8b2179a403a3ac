"""What every run shares: the files of a cell found by name, the seeds
derived from the run's seed, the check that no JAX module was loaded, and
the context the per-layer readers read."""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vae_cyclegan_tpu")


def sub_seed(seed: int, k: int) -> int:
    """The k-th independent seed of a run (weights 0, data 1, the engine's
    noise 2, requests' noise 3, the kept sample 4)."""
    return (seed * 8 + k) % 2 ** 62


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str, bench: Optional[dict] = None):
    """(cell, configuration) dicts of the cell `name`."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload named {name!r} in "
                         "BENCHMARK.json")
    cell = load_json(HERE / "workloads" / f"{name}.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return cell, load_json(ROOT / conf["file"])


def metrics_of(name: str, section: str, bench: Optional[dict] = None):
    """The entries of `section` ("end_to_end" or "per_layer") a cell
    reports: those that list it, and those without a list whose moved
    metric (per-layer) the cell reports."""
    bench = bench or benchmark()
    e2e = {m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])}
    if section == "end_to_end":
        return [m for m in bench["end_to_end"] if m["name"] in e2e]
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e else [])]


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a per-layer reader reads: the traced span of the device
    activity alone and the synchronising calls counted over it, the span
    with the host operators and their shapes (``op_span``), the window's
    readings, and the model FLOPs per image of the configuration."""

    def __init__(self, cfg: dict, cell: dict, span, op_span, syncs,
                 window: dict):
        self.cfg, self.cell = cfg, cell
        self.span, self.op_span = span, op_span
        self.syncs, self.window = syncs, window

    def flops_per_image(self, kind: str) -> float:
        from portbench.reference import flops

        return flops.per_image(self.cfg, kind, self.cell["params"]["batch_size"])
