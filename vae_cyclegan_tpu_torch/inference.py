"""Serving entry point: Gx for a batch of images (counterpart of
``run_inference`` in the JAX package's ``test.py``)."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from vae_cyclegan_tpu_torch.models.tasks.base import Task
from vae_cyclegan_tpu_torch.utils import spans


def normalize_batch_keys(batch: Mapping) -> Mapping:
    """Accept legacy 'A'/'B' batch keys alongside 'x'/'y' (the JAX package's
    ``test.py::normalize_batch_keys``): 'A' becomes 'x' and 'B' 'y', y falls
    back to A where 'B' is missing, other keys are kept. A batch that has
    'x', or no 'A', is returned as it is (the same object)."""
    if "x" not in batch and "A" in batch:
        mapped = {"x": batch["A"], "y": batch.get("B", batch["A"])}
        mapped.update({k: v for k, v in batch.items() if k not in ("A", "B")})
        return mapped
    return batch


def run_inference(task: Task, batch: Mapping, seed: int = 0) -> np.ndarray:
    """``task.generate`` on batch["x"] ((B, S, S, 3) float NHWC, numpy or
    torch; legacy batches keyed 'A'/'B' are mapped by
    ``normalize_batch_keys``), with reparameterization noise drawn from a
    generator seeded with `seed` on the task's device. Returns the output
    clipped to [0, 1] as a float32 NHWC numpy array. While a profiler
    records, the call is a ``vct.request`` unit of the spans
    ``vct.to_device``, ``vct.generate`` and ``vct.to_host``
    (``utils.spans``)."""
    with spans.unit("vct.request"):
        with spans.span("vct.to_device"):
            x = torch.as_tensor(normalize_batch_keys(batch)["x"]).float()
            x = x.to(task.device)
        generator = torch.Generator(device=task.device).manual_seed(seed)
        with spans.span("vct.generate"):
            out = task.generate({"x": x}, generator=generator)
        with spans.span("vct.to_host"):
            return out.float().clamp(0.0, 1.0).cpu().numpy()
