"""Task base: one object per architecture that owns its networks, their
device, their weights and optimizers, and exposes the protocol

    init(seed)                                   draw fresh weights
    train_step(batch, eps=None, generator=None)  -> metrics (one G/D step)
    eval_step(batch, eps=None, generator=None)   -> metrics + images
    generate(batch, generator=None, eps=None)    -> Gx, NHWC

Counterpart of ``vae_cyclegan_tpu/models/tasks/base.py``. The JAX task is
pure and threads a TrainState; here the task holds the state: the networks'
parameters and spectral buffers (``state_dict``) and the Adam states of its
optimizers. Batches are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn

from vae_cyclegan_tpu_torch.config import LossConfig, ModelConfig, OptimConfig
from vae_cyclegan_tpu_torch.models.blocks import ReflectConv
from vae_cyclegan_tpu_torch.models.networks import SpectralConv


class Task:
    """Base class; subclasses set `name`, fill `self.nets` and implement
    the protocol."""

    name: str = "base"
    #: whether eval_step emits a second image stream 'Fy' (Cycle/Double archs)
    has_fy: bool = False

    def __init__(self, model: Optional[ModelConfig] = None,
                 optim: Optional[OptimConfig] = None,
                 loss: Optional[LossConfig] = None, paired: bool = True,
                 device="cpu"):
        self.mc = model or ModelConfig()
        self.oc = optim or OptimConfig()
        self.lc = loss or LossConfig()
        self.paired = paired
        self.device = torch.device(device)
        #: the task's networks; their state_dict keys carry the reference's
        #: prefixes ("G.", "F.", "DX.", ...)
        self.nets = nn.ModuleDict()

    def init(self, seed: int) -> None:
        """Fresh weights: every conv weight Kaiming-normal (fan_out, relu
        gain, as the composites' re-init), every bias zero, the spectral
        vectors unit-normal, drawn in state_dict order from one CPU
        generator seeded with `seed`."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.nets.modules():
            if isinstance(module, (ReflectConv, SpectralConv)):
                module.reset_parameters(gen)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.nets.state_dict()

    def load_state_dict(self, sd: Mapping[str, torch.Tensor],
                        strict: bool = True):
        return self.nets.load_state_dict(sd, strict=strict)

    # -- helpers ----------------------------------------------------------

    def _adam(self, params: Iterable[nn.Parameter]) -> torch.optim.Adam:
        """Adam with the reference's settings (betas 0.5/0.999, eps 1e-8)."""
        return torch.optim.Adam(list(params), lr=self.oc.lr,
                                betas=self.oc.betas, eps=self.oc.eps)

    @staticmethod
    def _finite_update(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                       params: Sequence[nn.Parameter],
                       grads: Sequence[torch.Tensor]) -> float:
        """Apply the optimizer step only when the loss is finite; on a
        non-finite loss the step is skipped whole (parameters, moments and
        Adam's count stay as they were). Returns the nan_detected flag, 1.0
        when skipped. Reading the loss's finiteness waits for the device."""
        finite = bool(torch.isfinite(loss))
        if finite:
            for p, g in zip(params, grads):
                p.grad = g
            optimizer.step()
        for p in params:
            p.grad = None
        return 0.0 if finite else 1.0

    def _nchw(self, images) -> torch.Tensor:
        """An NHWC float batch (numpy or torch) as an f32 NCHW tensor on the
        task's device."""
        t = torch.as_tensor(images).to(self.device, torch.float32)
        return t.permute(0, 3, 1, 2).contiguous()

    # -- protocol ----------------------------------------------------------

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def generate(self, batch: Mapping[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward producing Gx only (the reference's ``model(...)[0]``)."""
        raise NotImplementedError
