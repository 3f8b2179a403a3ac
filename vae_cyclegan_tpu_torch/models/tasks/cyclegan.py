"""The flagship CycleVAEGAN (counterpart of
``vae_cyclegan_tpu/models/tasks/cyclegan.py``): two variational generators,
G (X -> Y) and F (Y -> X). This slice serves G; the discriminators, losses
and the alternating G/D step come with the training slice.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from vae_cyclegan_tpu_torch.models.networks import VariationalAutoencoderNet
from vae_cyclegan_tpu_torch.models.tasks.base import Task


class CycleVAEGANTask(Task):
    name = "cyclevaegan"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        for key in ("G", "F"):
            self.nets[key] = VariationalAutoencoderNet(
                self.mc.latent_dim, self.mc.base_width, self.mc.dtype,
                self.device)

    @property
    def G(self) -> VariationalAutoencoderNet:
        return self.nets["G"]

    @property
    def F(self) -> VariationalAutoencoderNet:
        return self.nets["F"]

    @torch.no_grad()
    def generate(self, batch: Mapping[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """G(x)[0]. batch["x"] is (B, S, S, 3) NHWC, as in the JAX task;
        `eps`, when given, is the reparameterization noise in NHWC,
        (B, S/16, S/16, latent_dim); otherwise it is drawn from `generator`.
        Returns (B, S, S, 3) NHWC in the compute dtype."""
        x = torch.as_tensor(batch["x"]).to(self.device)
        x = x.permute(0, 3, 1, 2).contiguous()
        if eps is not None:
            eps = torch.as_tensor(eps).to(self.device).permute(0, 3, 1, 2)
        gx, _, _ = self.G(x, eps=eps, generator=generator)
        return gx.permute(0, 2, 3, 1)
