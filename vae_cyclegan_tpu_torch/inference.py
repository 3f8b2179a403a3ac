"""Serving entry point: Gx for a batch of images (counterpart of
``run_inference`` in the JAX package's ``test.py``)."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from vae_cyclegan_tpu_torch.models.tasks.base import Task


def run_inference(task: Task, batch: Mapping, seed: int = 0) -> np.ndarray:
    """``task.generate`` on batch["x"] ((B, S, S, 3) float NHWC, numpy or
    torch), with reparameterization noise drawn from a generator seeded
    with `seed` on the task's device. Returns the output clipped to [0, 1]
    as a float32 NHWC numpy array."""
    x = torch.as_tensor(batch["x"]).float()
    generator = torch.Generator(device=task.device).manual_seed(seed)
    out = task.generate({"x": x}, generator=generator)
    return out.float().clamp(0.0, 1.0).cpu().numpy()
