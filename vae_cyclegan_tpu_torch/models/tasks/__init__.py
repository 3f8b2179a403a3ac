"""Architecture registry: string name -> Task class, with the ten names of
the JAX package, every one ported (training, evaluation and serving)."""

from __future__ import annotations

from typing import Dict, Optional, Type

from vae_cyclegan_tpu_torch.config import LossConfig, ModelConfig, OptimConfig
from vae_cyclegan_tpu_torch.models.tasks.base import Task
from vae_cyclegan_tpu_torch.models.tasks.cycle import CycleAETask, CycleVAETask
from vae_cyclegan_tpu_torch.models.tasks.cyclegan import (
    CycleAEGANTask,
    CycleVAEGANTask,
)
from vae_cyclegan_tpu_torch.models.tasks.gan import AEGANTask, VAEGANTask
from vae_cyclegan_tpu_torch.models.tasks.simple import (
    AutoencoderTask,
    DoubleAETask,
    DoubleVAETask,
    VAETask,
)

ARCHITECTURES: Dict[str, Type[Task]] = {
    "autoencoder": AutoencoderTask,
    "doubleae": DoubleAETask,
    "doublevae": DoubleVAETask,
    "vae": VAETask,
    "aegan": AEGANTask,
    "vaegan": VAEGANTask,
    "cycleae": CycleAETask,
    "cyclevae": CycleVAETask,
    "cycleaegan": CycleAEGANTask,
    "cyclevaegan": CycleVAEGANTask,
}


def create_task(architecture: str, model: Optional[ModelConfig] = None,
                optim: Optional[OptimConfig] = None,
                loss: Optional[LossConfig] = None, paired: bool = True,
                device="cuda") -> Task:
    """The task of `architecture` on `device`: the card unless the caller
    asks for another device (raises without a CUDA device)."""
    if architecture not in ARCHITECTURES:
        raise ValueError(f"Unknown architecture: {architecture}")
    return ARCHITECTURES[architecture](model=model, optim=optim, loss=loss,
                                       paired=paired, device=device)
