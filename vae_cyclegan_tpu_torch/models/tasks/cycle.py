"""Cycle-consistency tasks without discriminators (counterpart of
``vae_cyclegan_tpu/models/tasks/cycle.py``): CycleAE and CycleVAE. Two
generators, G (X -> Y) and F (Y -> X), under one Adam; per step the passes
G(x), F(Gx), F(y), G(Fy), in the reference's order. 'paired' adds the
translation losses L1(Gx, y) + L1(Fy, x).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from vae_cyclegan_tpu_torch import losses
from vae_cyclegan_tpu_torch.models.networks import (
    AutoencoderNet,
    VariationalAutoencoderNet,
)
from vae_cyclegan_tpu_torch.models.tasks.base import Task


class _CycleTask(Task):
    """G and F, one Adam over both; CycleVAE adds the four KL terms."""

    has_fy = True
    variational = False

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        for key in ("G", "F"):
            self.nets[key] = (
                VariationalAutoencoderNet(self.mc.latent_dim,
                                          self.mc.base_width,
                                          **self._net_kw())
                if self.variational
                else AutoencoderNet(self.mc.base_width, **self._net_kw()))
        self.params = list(self.nets.parameters())
        self.opt = self._adam(self.params)

    @property
    def G(self):
        return self.nets["G"]

    @property
    def F(self):
        return self.nets["F"]

    def _losses(self, batch, eps, generator):
        """(Gx, Fy, total, the metrics' loss terms); `eps` is ``_eps``'s
        list, empty for autoencoders."""
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        e = eps or [None] * 4
        Gx, mu_x, lv_x = self._gen(self.G, x, e[0], generator)
        FGx, mu_FGx, lv_FGx = self._gen(self.F, Gx, e[1], generator)
        Fy, mu_y, lv_y = self._gen(self.F, y, e[2], generator)
        GFy, mu_GFy, lv_GFy = self._gen(self.G, Fy, e[3], generator)
        loss_cycle = losses.cycle_consistency_loss(x, y, FGx, GFy)
        total = self.lc.lambda_cycle * loss_cycle
        parts = {"loss_cycle": loss_cycle}
        if self.variational:
            loss_kl = (losses.kl_divergence(mu_x, lv_x)
                       + losses.kl_divergence(mu_FGx, lv_FGx)
                       + losses.kl_divergence(mu_y, lv_y)
                       + losses.kl_divergence(mu_GFy, lv_GFy))
            total = total + self.lc.lambda_kl * loss_kl
            parts["loss_kl"] = loss_kl
        if self.paired:
            loss_trans = (losses.translation_loss(Gx, y)
                          + losses.translation_loss(Fy, x))
            total = total + loss_trans
            parts["loss_trans"] = loss_trans
        return Gx, Fy, total, parts

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        _, _, total, parts = self._losses(
            batch, self._eps(eps, self.train_passes), generator)
        nan = self._step(self.opt, total, self.params, batch)
        return self._scalars({"total_loss": total, "G_loss": total, **parts},
                             nan)

    @torch.no_grad()
    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        Gx, Fy, total, parts = self._losses(
            batch, self._eps(eps, self.eval_passes), generator)
        return {"total_loss": total, "G_loss": total, **parts,
                "Gx": self._nhwc(Gx), "Fy": self._nhwc(Fy)}

    @torch.no_grad()
    def generate(self, batch, generator=None, eps=None) -> torch.Tensor:
        e = self._generate_eps(eps)
        return self._nhwc(self._gen(self.G, self._nchw(batch["x"]), e,
                                    generator)[0])


class CycleAETask(_CycleTask):
    """G, F autoencoders; loss = lambda_cycle * cycle (+ trans if paired)."""

    name = "cycleae"


class CycleVAETask(_CycleTask):
    """G, F VAEs; adds lambda_kl * the KL terms of G(x), F(Gx), F(y) and
    G(Fy)."""

    name = "cyclevae"
    variational = True
    train_passes = ("G(x)", "F(Gx)", "F(y)", "G(Fy)")
