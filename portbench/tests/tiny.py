"""A copy of the harness in a scratch directory with tiny cells of every
driver added as new files, for CPU runs of the whole harness in a
subprocess (no card: ``run.main(argv, device="cpu")``)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {"image_size": 64, "base_width": 8, "latent_dim": 8}
PARAMS = {
    "tiny.s2w.train": {
        "dataset": "summer2winter", "frames_a": 5, "frames_b": 4,
        "frame_hw": [72, 80], "batch_size": 2, "num_workers": 2,
        "hflip_p": 0.5, "jitter": [0.2, 0.2, 0.2, 0.1], "trace_after": 1,
        "trace_steps": 1},
    "tiny.hypersim.train": {
        "dataset": "hypersim", "modalities": ["depth", "normal"],
        "frames": 3, "frame_hw": [60, 80], "epoch_samples": 40,
        "decode_cache": True, "device_aug": True, "batch_size": 2,
        "num_workers": 2, "hflip_p": 0.5, "vflip_p": 0.3, "trace_after": 1,
        "trace_steps": 1},
    "tiny.serve": {"batch_size": 2, "pool": 2, "warmup_requests": 1,
                   "kept_share": 0.5, "trace_requests": 2},
}
CONFIG = {"tiny.s2w.train": "cyclevaegan-256",
          "tiny.hypersim.train": "vaegan-256",
          "tiny.serve": "cyclevaegan-256"}
DRIVER = {"tiny.s2w.train": "train", "tiny.hypersim.train": "train",
          "tiny.serve": "serve"}
#: at f32 on the CPU the program's plain path and the reference agree to
#: rounding in the first step (the gradients to rounding amplified by
#: InstanceNorm over 4x4 planes); after one Adam update the two drift
#: apart at this size (steps 2-3 and the change are not held here)
LIMITS = {"train": {"g_loss_step1": 1e-4, "d_loss_step1": 1e-4,
                    "grad_leaf": 5e-2},
          "serve": {"image_rms": 1e-3}}


def make_tree(dest: Path) -> Path:
    """dest/portbench (a copy), dest/BENCHMARK.json with the tiny cells
    only, tiny configs and cells as new files; returns dest."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = []
    for conf in bench["configs"]:
        cfg = json.loads((REPO / conf["file"]).read_text())
        cfg.update(TINY, name="tiny-" + conf["name"],
                   compute_dtype="float32")
        path = f"portbench/configs/tiny-{conf['name']}.json"
        (dest / path).write_text(json.dumps(cfg))
        configs.append({**conf, "name": cfg["name"], "file": path})
    bench["configs"] = configs
    bench["workloads"] = []
    for name, params in PARAMS.items():
        kind = DRIVER[name]
        cell = {"name": name, "config": "tiny-" + CONFIG[name],
                "traffic": name, "driver": kind, "chips": 1, "why": name,
                "params": params, "limits": LIMITS[kind]}
        (dest / "portbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(cell))
        bench["workloads"].append({k: cell[k] for k in
                                   ("name", "config", "traffic", "chips",
                                    "why")})
    train = [n for n in PARAMS if DRIVER[n] == "train"]
    serve = [n for n in PARAMS if DRIVER[n] == "serve"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = train if m["name"].endswith(
                ("train", "train_images_per_s")) else serve
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def run(dest: Path, argv, code: str = "", timeout: int = 600):
    """`run.main(argv, device="cpu")` in a subprocess at `dest` (with
    `code` run first, for planted faults); (returncode, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=f"{dest}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    script = (f"import sys\n{code}\nfrom portbench import run\n"
              f"sys.exit(run.main({list(argv)!r}, device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=dest, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr
