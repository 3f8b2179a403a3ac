"""Checkpoints in the JAX package's run-directory layout, holding the
reference's ``.pth`` dict.

Counterpart of ``vae_cyclegan_tpu/utils/checkpoint.py``. A checkpoint is a
directory (``checkpoint_epoch_{N}/``, ``best_model/``,
``checkpoint_preempt/``) holding ``meta.json`` ({epoch, loss, args}, as in
the JAX package) and ``state.pth``, one ``torch.save`` of the reference's
checkpoint dict (reference utils.py:17-28):

    epoch, loss, args
    model_state_dict   task.state_dict(): parameters and the spectral
                       weight_u / weight_v buffers under the reference's keys
    optimizer_states   {"optimizer"} or {"optimizer_G", "optimizer_D"}: each
                       Adam's state_dict, in the reference's optimizer order
    generator_state    the Engine's training noise generator (the
                       counterpart of the JAX TrainState's rng); absent when
                       saved without an engine

The JAX package's ``utils/torch_import.load_into_state`` and
``load_adam_moments_into_state`` read ``model_state_dict`` and
``optimizer_states`` (unknown keys are ignored), so
``scripts/import_torch_checkpoint.py`` takes a port run's ``state.pth``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

_META = "meta.json"
_STATE = "state.pth"


def save_checkpoint(task, epoch: int, loss: float,
                    args: Optional[Dict[str, Any]], path: os.PathLike,
                    engine=None) -> None:
    """Write the task's weights, its Adam states and (with `engine`) the
    training generator's state to `path/`."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    state = {
        "epoch": int(epoch),
        "model_state_dict": task.state_dict(),
        "optimizer_states": {k: opt.state_dict()
                             for k, opt in task.optimizers().items()},
        "loss": float(loss),
        "args": args or {},
    }
    if engine is not None:
        state["generator_state"] = engine.generator.get_state()
    torch.save(state, path / _STATE)
    meta = {"epoch": int(epoch), "loss": float(loss), "args": args or {}}
    with open(path / _META, "w") as f:
        json.dump(meta, f, indent=2)
    print(f"Checkpoint saved to {path}")


def checkpoint_exists(path: os.PathLike) -> bool:
    path = Path(path)
    return (path / _META).exists() and (path / _STATE).exists()


def load_checkpoint(task, path: os.PathLike, engine=None
                    ) -> Tuple[int, float, Dict[str, Any]]:
    """Restore a checkpoint in place: the task's weights and Adam states on
    its device, and (with `engine`, where the file holds one) the training
    generator's state. Returns (epoch, loss, args)."""
    path = Path(path).absolute()
    if not checkpoint_exists(path):
        raise FileNotFoundError(f"No checkpoint found at {path}")
    state = torch.load(path / _STATE, map_location="cpu", weights_only=True)
    task.load_state_dict(state["model_state_dict"])
    optimizers = task.optimizers()
    saved = state["optimizer_states"]
    if set(saved) != set(optimizers):
        raise KeyError(f"{path}: optimizer states {sorted(saved)}, the task "
                       f"has {sorted(optimizers)}")
    for key, opt in optimizers.items():
        opt.load_state_dict(saved[key])
    if engine is not None and "generator_state" in state:
        engine.generator.set_state(state["generator_state"])
    with open(path / _META) as f:
        meta = json.load(f)
    print(f"Loaded checkpoint from {path} (epoch {meta['epoch']}, "
          f"loss {meta['loss']:.4f})")
    return meta["epoch"], meta["loss"], meta.get("args", {})
