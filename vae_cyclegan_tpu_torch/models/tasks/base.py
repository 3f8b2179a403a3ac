"""Task base: one object per architecture that owns its networks, their
device and their weights, and exposes the serving protocol

    init(seed)                                  draw fresh weights
    generate(batch, generator=None, eps=None)   -> Gx, NHWC

Counterpart of ``vae_cyclegan_tpu/models/tasks/base.py``. The optimizer and
loss settings, the data mode (paired or not), the train/eval steps and the
finite-loss guard come with the training slice, which reads them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.models.blocks import ReflectConv


class Task:
    """Base class; subclasses set `name`, fill `self.nets` and implement
    the protocol."""

    name: str = "base"

    def __init__(self, model: Optional[ModelConfig] = None, device="cpu"):
        self.mc = model or ModelConfig()
        self.device = torch.device(device)
        #: the task's networks; their state_dict keys carry the reference's
        #: prefixes ("G.", "F.", ...)
        self.nets = nn.ModuleDict()

    def init(self, seed: int) -> None:
        """Fresh weights: every conv weight Kaiming-normal (fan_out, relu
        gain, as the composites' re-init), every bias zero, drawn in
        state_dict order from one CPU generator seeded with `seed`."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.nets.modules():
            if isinstance(module, ReflectConv):
                module.reset_parameters(gen)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.nets.state_dict()

    def load_state_dict(self, sd: Mapping[str, torch.Tensor],
                        strict: bool = True):
        return self.nets.load_state_dict(sd, strict=strict)

    def generate(self, batch: Mapping[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward producing Gx only (the reference's ``model(...)[0]``)."""
        raise NotImplementedError
