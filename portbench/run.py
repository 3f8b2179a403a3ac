"""One run of one cell: ``python3 -m portbench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Set-up (the cell's data, weights and program, its shapes warmed and its
first steps compared later), then the window of ``--seconds``, then with
``--trace 1`` two profiled spans; then the program is released and the
reference decides ``correct``. The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared number
with its limit (also the last lines of standard error). No result, and a
non-zero exit, without a CUDA device for each chip the cell asks for, or
when a JAX module was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import harness  # noqa: E402

#: every compile cache of a run, at a fixed place inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions"}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi did not run: {e}"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None) -> int:
    """`device` None runs on the card (and refuses without one); the tests
    pass "cpu"."""
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(harness.ROOT / "build" / sub)
    bench = harness.benchmark()
    cell, cfg = harness.cell_files(args.workload, bench)
    import torch

    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            log(f"portbench: {args.workload} needs {cell['chips']} CUDA "
                f"device(s); this machine has {have}")
            return 2
        device = "cuda"
    scratch = Path(tempfile.mkdtemp(prefix="portbench-"))
    cuda = torch.device(device).type == "cuda"
    try:
        driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
        run = driver.Cell(cell, cfg, args.seed, device,
                                           scratch, log)
        run.setup()
        setup_s = time.perf_counter() - T0
        log(f"set-up {setup_s:.4f} s")
        win = run.window(args.seconds)
        values = {"setup_s": setup_s, **win["metrics"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in harness.metrics_of(args.workload, "end_to_end",
                                               bench)}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": cell["chips"]}
        extra = {}
        if args.trace:
            from portbench.metrics import reader

            span, op_span, syncs = run.trace()
            ctx = harness.Context(cfg, cell, span, op_span, syncs, win)
            for what, sp in (("device activity", span),
                             ("with host operators", op_span)):
                if sp is not None:
                    log(f"trace ({what}): {sp.window_s / sp.units:.6f} s a "
                        f"unit against {win['s_per_unit']:.6f} s in the "
                        "window, ratio "
                        f"{sp.window_s / sp.units / win['s_per_unit']:.4f}")
            metrics = {}
            for m in harness.metrics_of(args.workload, "per_layer", bench):
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if span is not None:
                dev.update(busy_s=span.busy_s, window_s=span.window_s)
                extra["breakdown"] = {"device_ops": span.device_ops(),
                                      "idle_gaps": span.idle_gaps()}
        dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if cuda else 0)
        if cuda:
            log(f"card: {_card()}")
        run.release()
        numbers = run.compare(list(cell["limits"]))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    from portbench import check

    correct, rows = check.verdict(numbers, cell["limits"])
    bad = harness.loaded_forbidden()
    if bad:
        log(f"portbench: modules loaded that may not be: {', '.join(bad)}")
        return 3
    for name, value, limit in rows:
        log(f"check {name} {value!r} limit {limit!r}")
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev,
              **extra,
              "checks": {name: {"value": value, "limit": limit}
                         for name, value, limit in rows}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
