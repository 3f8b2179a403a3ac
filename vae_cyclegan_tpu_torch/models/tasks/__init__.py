"""Architecture registry: string name -> Task factory, with the ten names
of the JAX package. Only the flagship is ported so far (serving and
training); the others raise NotImplementedError naming their ROADMAP.md
queue item."""

from __future__ import annotations

from typing import Dict, Optional, Type

from vae_cyclegan_tpu_torch.config import LossConfig, ModelConfig, OptimConfig
from vae_cyclegan_tpu_torch.models.tasks.base import Task
from vae_cyclegan_tpu_torch.models.tasks.cyclegan import CycleVAEGANTask

ARCHITECTURES: Dict[str, Optional[Type[Task]]] = {
    "autoencoder": None,
    "doubleae": None,
    "doublevae": None,
    "vae": None,
    "aegan": None,
    "vaegan": None,
    "cycleae": None,
    "cyclevae": None,
    "cycleaegan": None,
    "cyclevaegan": CycleVAEGANTask,
}


def create_task(architecture: str, model: Optional[ModelConfig] = None,
                optim: Optional[OptimConfig] = None,
                loss: Optional[LossConfig] = None, paired: bool = True,
                device="cpu") -> Task:
    if architecture not in ARCHITECTURES:
        raise ValueError(f"Unknown architecture: {architecture}")
    cls = ARCHITECTURES[architecture]
    if cls is None:
        raise NotImplementedError(
            f"architecture {architecture!r} is not ported yet: ROADMAP.md, "
            "'Modules to port', item 3 (the other nine architectures)")
    return cls(model=model, optim=optim, loss=loss, paired=paired,
               device=device)
