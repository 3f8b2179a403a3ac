"""The readings the limits of a cell's comparison are set from, in one
process on the card (not part of a benchmark run):

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 ... \
        --controls 3 --out chiprun_out/cal.jsonl

Per seed: the program's readings at the cell's own sizes, by the run's own
set-up and comparison (the lower reading of each number is the largest of
these); for the first ``--controls`` seeds also the control, the reference
with its convs' operands in float8 e4m3 (the precision below the
configuration's bfloat16) put in the program's place, and the cell's
planted faults, each against the float32 reference of the same seed.
Training (``drivers.train.FAULTS``): half of each batch left out (the mean
over the rest), the reconstruction weights (cycle, recon) x1.1, every
generator output x1.01 where it is produced; a step that leaves its state
unchanged reads 1 by construction and is not run. Beyond the numbers a run
compares, each training reading carries the worst leaves, the leaf norms
and per leaf the first gradients' difference (``grad_diff``: its norm over
the larger of the reference leaf's norm and the median leaf's).
Serving: the request's noise seed dropped (every request drawn with seed 0)
and one image's answer swapped with its neighbour's. One JSON line per
reading.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import math
import statistics

import torch

from portbench import check, harness
from portbench.reference.nets import Precision


def diff_gaps(program, reference, ref_norms, keep) -> list:
    """Per leaf of `keep`, ||program - reference|| over max(the reference
    leaf's norm, the median leaf's); a leaf the program lacks, or of
    another shape, reads inf."""
    median = statistics.median(ref_norms.values())
    out = []
    for k in keep:
        p, r = program.get(k), reference[k]
        if p is None or p.shape != r.shape:
            out.append(math.inf)
            continue
        d = float(torch.linalg.vector_norm(p.float() - r.float()))
        out.append(d / max(ref_norms[k], median, 1e-30)
                   if math.isfinite(d) else math.inf)
    return out


def _leaves(got, ref) -> dict:
    keep = check.moving_leaves(ref["grad"])
    diff = diff_gaps(got["grad_vec"], ref["grad_vec"], ref["grad"], keep)
    return {"grad": check.worst_leaves(got["grad"], ref["grad"], keep),
            "change": check.worst_leaves(got["change"], ref["change"], keep),
            "losses": got["losses"], "ref_losses": ref["losses"],
            "norms": {k: [got[k], ref[k]] for k in ("grad", "change")},
            "grad_diff_leaf": max(diff, default=0.0),
            "grad_diff_median_leaf": statistics.median(diff),
            "diff": dict(zip(keep, diff))}


def _train(run, seed, control: bool, emit) -> None:
    from portbench.drivers.train import FAULTS

    run.keep_grad_vec = True
    run.setup()
    prog = run.program
    run.release()
    ref = run.reference()
    emit(seed, "program", check.training_numbers(prog, ref),
         _leaves(prog, ref))
    if control:
        got = run.reference(Precision("fp8"))
        emit(seed, "control_fp8", check.training_numbers(got, ref),
             _leaves(got, ref))
        for fault in FAULTS:
            got = run.reference(fault=fault)
            emit(seed, fault, check.training_numbers(got, ref),
                 _leaves(got, ref))


def _serve(run, seed, control: bool, emit, seconds: float) -> None:
    run.setup()
    run.window(seconds)
    run.release()
    ref = run.reference()
    emit(seed, "program", run.numbers(ref), run.per_image(ref))
    if control:
        kept = run.kept
        run.kept = {i: a.cpu().numpy() for i, a in
                    run.reference(Precision("fp8")).items()}
        emit(seed, "control_fp8", run.numbers(ref), run.per_image(ref))
        seedless = run.request_seed
        run.request_seed = lambda s, i: 0
        run.kept = {i: a.cpu().numpy() for i, a in run.reference().items()}
        run.request_seed = seedless
        emit(seed, "noise_seed_dropped", run.numbers(ref))
        run.kept = {i: a[[1, 0, *range(2, len(a))]] for i, a in kept.items()}
        emit(seed, "images_swapped", run.numbers(ref))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--compute-dtype", default=None,
                    help="run the program in this dtype instead of the "
                    "configuration's (a witness; float32 with TF32 off)")
    args = ap.parse_args(argv)
    cell, cfg = harness.cell_files(args.workload)
    if args.compute_dtype:
        cfg = {**cfg, "compute_dtype": args.compute_dtype}
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def emit(seed, kind, numbers, detail=None):
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "compute_dtype": cfg["compute_dtype"],
                           "kind": kind, "numbers": numbers,
                           "detail": detail})
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")

    for k, seed in enumerate(args.seeds):
        t = time.perf_counter()
        scratch = Path(tempfile.mkdtemp(prefix="portbench-cal-"))
        try:
            run = driver.Cell(cell, cfg, seed, "cuda", scratch,
                              lambda *a: print(*a, file=sys.stderr))
            if cell["driver"] == "serve":
                _serve(run, seed, k < args.controls, emit, args.seconds)
            else:
                _train(run, seed, k < args.controls, emit)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
            torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
