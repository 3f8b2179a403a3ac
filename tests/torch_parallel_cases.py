"""The cases of tests/test_torch_parallel.py, run by every rank of a gloo
group (``run_rank``, through ``parallel.mesh.spawn``) and by one process
over the global batch (``run_cases(inputs, 0, 1, None)``).

This module imports torch and the port only: the spawned ranks must not
import JAX (the pytest process that spawns them has it loaded, with its
threads). Inputs and results cross as ``torch.save`` files. Small size:
image 32, base 8, latent 8, f32, one torch thread a process.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.data import DataLoader
from vae_cyclegan_tpu_torch.engine import Engine
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.parallel import mesh
from vae_cyclegan_tpu_torch.utils.preempt import AgreedStop, GracefulShutdown

IMAGE, BASE, LATENT = 32, 8, 8
#: the engine epoch's data: 11 samples in batches of 4 (4, 4, 3: the last
#: does not divide two ranks and is replicated)
EPOCH_SAMPLES, EPOCH_BATCH = 11, 4


def task_for(name: str, params, paired: bool = True):
    task = create_task(name, model=ModelConfig(IMAGE, LATENT, BASE),
                       paired=paired, device="cpu")
    task.load_state_dict(params, strict=True)
    return task


def snapshot(task) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer, and every Adam state tensor, copied."""
    out = {f"sd/{k}": v.detach().clone()
           for k, v in task.state_dict().items()}
    for name, opt in task.optimizers().items():
        for i, state in opt.state_dict()["state"].items():
            for k, v in state.items():
                out[f"{name}/{i}/{k}"] = torch.as_tensor(v).clone()
    return out


def floats(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()
            if k not in ("Gx", "Fy")}


def rows(a, rank: int, world: int):
    """This rank's rows of a global array (``mesh.shard_rows``)."""
    lo, hi = mesh.shard_rows(a.shape[0], rank, world)
    return a[lo:hi]


def local_batch(batch, rank, world):
    return {k: torch.from_numpy(np.ascontiguousarray(rows(v, rank, world)))
            for k, v in batch.items()}


class EpochData:
    """Seeded synthetic paired samples, content by index and augmentation
    draw (so a wrong shard or a wrong global position shows)."""

    def __len__(self):
        return EPOCH_SAMPLES

    def get(self, idx: int, rng: random.Random):
        r = np.random.RandomState(idx)
        x = r.rand(IMAGE, IMAGE, 3).astype(np.float32)
        x += np.float32(rng.random() * 1e-3)
        return {"x": x, "y": r.rand(IMAGE, IMAGE, 3).astype(np.float32)}


def run_cases(inputs: dict, rank: int, world: int, group,
              only: Optional[tuple] = None) -> dict:
    """Every case of `inputs` on this rank's shards (or, at world 1 without
    a group, on the global batches). `only`: the step names to run."""
    torch.set_num_threads(1)
    out = {}
    for name, case in inputs["steps"].items():
        if only is not None and name not in only:
            continue
        task = task_for(name, case["params"], case["paired"])
        engine = Engine(task, seed=0, group=group)
        batch = local_batch(case["batch"], rank, world)
        eps = [rows(e, rank, world) for e in case["eps"]] or None
        m = engine.train_step(batch, eps=eps)
        out[f"step/{name}"] = {"metrics": floats(m), "state": snapshot(task)}
        if name == "cyclevaegan":  # a second step, its noise drawn
            m = engine.train_step(batch)
            out["twice/cyclevaegan"] = {"metrics": floats(m),
                                        "state": snapshot(task)}
    if only is not None:
        return out

    # the noise drawn, not given: dp_normal's global rows
    case = inputs["steps"]["vae"]
    task = task_for("vae", case["params"])
    engine = Engine(task, seed=3, group=group)
    m = engine.train_step(local_batch(case["batch"], rank, world))
    out["drawn/vae"] = {"metrics": floats(m), "state": snapshot(task)}

    # a global batch of 3 on every rank, replicated, its noise drawn whole
    task = task_for("vae", case["params"])
    engine = Engine(task, seed=3, group=group)
    odd = {k: torch.from_numpy(v[:3]) for k, v in case["batch"].items()}
    part, replicated = mesh.shard_batch(odd, rank, world)
    m = engine.train_step(part, replicated=replicated)
    out["ragged/vae"] = {"metrics": floats(m), "state": snapshot(task),
                         "replicated": replicated,
                         "rows": int(part["x"].shape[0])}

    # a NaN in rank 1's shard (the global batch's row 2) skips every rank
    task = task_for("vae", case["params"])
    engine = Engine(task, seed=3, group=group)
    bad = {k: v.copy() for k, v in case["batch"].items()}
    bad["x"][2, 0, 0, 0] = np.nan
    before = snapshot(task)
    m = engine.train_step(local_batch(bad, rank, world))
    after = snapshot(task)
    out["nan/vae"] = {"metrics": floats(m), "unchanged": all(
        torch.equal(before[k], after[k]) for k in before)}

    # eval_step (noise given) and generate (noise drawn): gathered images
    ev = inputs["eval"]
    task = task_for("cyclevaegan", ev["params"], paired=False)
    engine = Engine(task, seed=0, group=group)
    batch = local_batch(ev["batch"], rank, world)
    m = engine.eval_step(batch, eps=[rows(e, rank, world) for e in ev["eps"]])
    gen = torch.Generator().manual_seed(5)
    out["eval/cyclevaegan"] = {
        "metrics": floats(m), "Gx": m["Gx"].clone(), "Fy": m["Fy"].clone(),
        "generate": engine.generate(batch, generator=gen).clone()}

    # a stop asked on rank 1 alone: every rank's from the next poll on
    if group is not None:
        local = GracefulShutdown(signals=())
        stop = AgreedStop(local, group)
        first = stop()
        local.requested = rank == 1
        out["stop"] = {"first": first, "second": stop(),
                       "requested": stop.requested}

    # one engine epoch and a validation pass over a sharded loader
    task = task_for("vae", case["params"])
    engine = Engine(task, seed=1, group=group)
    shard = ({} if group is None else {"shard_index": rank,
                                       "shard_count": world,
                                       "ragged": "replicate"})
    loader = DataLoader(EpochData(), EPOCH_BATCH, shuffle=True, seed=0,
                        num_workers=1, use_processes=False, **shard)
    loss, comps, _ = engine.train_epoch(loader, progress=False)
    val_loss, val_comps, gx, _, x, _ = engine.validate(
        DataLoader(EpochData(), EPOCH_BATCH, num_workers=1,
                   use_processes=False, **shard),
        progress=False)
    out["epoch/vae"] = {"loss": loss, "comps": comps, "val_loss": val_loss,
                        "val_comps": val_comps, "gx": gx, "x": x,
                        "replicated": loader.replicated_batches(),
                        "state": snapshot(task)}
    return out


def run_rank(device, in_path: str, out_dir: str, only=None) -> None:
    """One rank's run of every case (``mesh.spawn``'s `fn`)."""
    inputs = torch.load(in_path, weights_only=False)
    rank, world = dist.get_rank(), dist.get_world_size()
    out = run_cases(inputs, rank, world, dist.group.WORLD, only)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
