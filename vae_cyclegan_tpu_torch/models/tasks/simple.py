"""Non-adversarial tasks (counterpart of
``vae_cyclegan_tpu/models/tasks/simple.py``): Autoencoder, VAE, DoubleAE
and DoubleVAE. Each trains one network under one Adam. The task's ``nets``
is that network itself, so its ``state_dict`` keys are the reference's
(``encoder.model.0.conv.weight``, ``decoder_A...``), without a prefix.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from vae_cyclegan_tpu_torch import losses
from vae_cyclegan_tpu_torch.models.composites import DoubleAENet, DoubleVAENet
from vae_cyclegan_tpu_torch.models.networks import (
    AutoencoderNet,
    VariationalAutoencoderNet,
)
from vae_cyclegan_tpu_torch.models.tasks.base import Task


class _OneNetTask(Task):
    """One network (``_build``) and one Adam over all its parameters."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.nets = self._build()
        self.params = list(self.nets.parameters())
        self.opt = self._adam(self.params)

    def _build(self) -> torch.nn.Module:
        raise NotImplementedError


class AutoencoderTask(_OneNetTask):
    """L1(G(x), y)."""

    name = "autoencoder"

    def _build(self):
        return AutoencoderNet(self.mc.base_width, **self._net_kw())

    def _losses(self, batch):
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        Gx = self._gen(self.nets, x, None, None)[0]
        return Gx, losses.translation_loss(Gx, y)

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        self._eps(eps, self.train_passes)
        _, loss = self._losses(batch)
        nan = self._step(self.opt, loss, self.params, batch)
        return self._scalars({"G_loss": loss, "loss_trans": loss,
                              "total_loss": loss}, nan)

    @torch.no_grad()
    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        self._eps(eps, self.eval_passes)
        Gx, loss = self._losses(batch)
        return {"G_loss": loss, "total_loss": loss, "loss_trans": loss,
                "Gx": self._nhwc(Gx)}

    @torch.no_grad()
    def generate(self, batch, generator=None, eps=None) -> torch.Tensor:
        self._generate_eps(eps)
        return self._nhwc(self.nets(self._nchw(batch["x"])))


class VAETask(_OneNetTask):
    """L1(G(x), y) + lambda_kl * KL(mu, logvar)."""

    name = "vae"
    train_passes = ("G(x)",)

    def _build(self):
        return VariationalAutoencoderNet(self.mc.latent_dim,
                                         self.mc.base_width,
                                         **self._net_kw())

    def _losses(self, batch, eps, generator):
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        Gx, mu, logvar = self._gen(self.nets, x, eps[0], generator)
        loss_trans = losses.translation_loss(Gx, y)
        loss_kl = losses.kl_divergence(mu, logvar)
        return Gx, loss_trans + self.lc.lambda_kl * loss_kl, {
            "loss_trans": loss_trans, "loss_kl": loss_kl}

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        _, g_loss, parts = self._losses(
            batch, self._eps(eps, self.train_passes), generator)
        nan = self._step(self.opt, g_loss, self.params, batch)
        return self._scalars({"G_loss": g_loss, **parts}, nan)

    @torch.no_grad()
    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        Gx, g_loss, parts = self._losses(
            batch, self._eps(eps, self.eval_passes), generator)
        return {"G_loss": g_loss, **parts, "Gx": self._nhwc(Gx)}

    @torch.no_grad()
    def generate(self, batch, generator=None, eps=None) -> torch.Tensor:
        e = self._generate_eps(eps)
        return self._nhwc(self.nets(self._nchw(batch["x"]), e, generator)[0])


class DoubleAETask(_OneNetTask):
    """Shared-encoder reconstruction of both modalities: L1(Gx, x) +
    L1(Gy, y); eval_step also emits the cross translations."""

    name = "doubleae"
    has_fy = True

    def _build(self):
        return DoubleAENet(self.mc.base_width, **self._net_kw())

    def _losses(self, x, y):
        Gx, Gy = self._maybe_remat(self.nets)(x, y)
        loss_a = losses.translation_loss(Gx, x)
        loss_b = losses.translation_loss(Gy, y)
        return loss_a + loss_b, {"loss_recon_A": loss_a,
                                 "loss_recon_B": loss_b}

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        self._eps(eps, self.train_passes)
        total, parts = self._losses(self._nchw(batch["x"]),
                                    self._nchw(batch["y"]))
        nan = self._step(self.opt, total, self.params, batch)
        return self._scalars({"G_loss": total, **parts, "total_loss": total},
                             nan)

    @torch.no_grad()
    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        self._eps(eps, self.eval_passes)
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        total, parts = self._losses(x, y)
        return {"G_loss": total, "total_loss": total, **parts,
                "Gx": self._nhwc(self.nets.translate_A_to_B(x)),
                "Fy": self._nhwc(self.nets.translate_B_to_A(y))}

    @torch.no_grad()
    def generate(self, batch, generator=None, eps=None) -> torch.Tensor:
        """Gx, x's reconstruction through decoder_A (the JAX task runs the
        y branch beside it and drops it)."""
        self._generate_eps(eps)
        x = self._nchw(batch["x"])
        return self._nhwc(self.nets.decoder_A(self.nets.encoder(x)))


class DoubleVAETask(_OneNetTask):
    """recon_A + recon_B + lambda_kl * (KL_A + KL_B); eval_step also emits
    the cross translations, each with a pass of its own."""

    name = "doublevae"
    has_fy = True
    train_passes = ("A(x)", "B(y)")

    @property
    def eval_passes(self):
        return self.train_passes + ("B(x)", "A(y)")

    def _build(self):
        return DoubleVAENet(self.mc.latent_dim, self.mc.base_width,
                            **self._net_kw())

    def _losses(self, x, y, eps, generator):
        if self._remat():  # both passes' noise before the checkpointed call
            eps = [self._noise(v, generator) if e is None else e
                   for v, e in zip((x, y), eps)]
        Gx, Gy, mu_x, lv_x, mu_y, lv_y = self._maybe_remat(self.nets)(
            x, y, eps[0], eps[1], generator)
        loss_a = losses.translation_loss(Gx, x)
        loss_b = losses.translation_loss(Gy, y)
        kl_a = losses.kl_divergence(mu_x, lv_x)
        kl_b = losses.kl_divergence(mu_y, lv_y)
        kl = kl_a + kl_b
        total = loss_a + loss_b + self.lc.lambda_kl * kl
        return total, {"loss_recon_A": loss_a, "loss_recon_B": loss_b,
                       "loss_kl": kl, "loss_kl_A": kl_a, "loss_kl_B": kl_b}

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        total, parts = self._losses(self._nchw(batch["x"]),
                                    self._nchw(batch["y"]),
                                    self._eps(eps, self.train_passes),
                                    generator)
        nan = self._step(self.opt, total, self.params, batch)
        return self._scalars({"G_loss": total, **parts, "total_loss": total},
                             nan)

    @torch.no_grad()
    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        e = self._eps(eps, self.eval_passes)
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        total, parts = self._losses(x, y, e, generator)
        return {"G_loss": total, "total_loss": total, **parts,
                "Gx": self._nhwc(self.nets.translate_A_to_B(x, e[2],
                                                            generator)),
                "Fy": self._nhwc(self.nets.translate_B_to_A(y, e[3],
                                                            generator))}

    @torch.no_grad()
    def generate(self, batch, generator=None, eps=None) -> torch.Tensor:
        """Gx, x's reconstruction through side A (the JAX task runs the y
        branch beside it and drops it)."""
        e = self._generate_eps(eps)
        z, _, _ = self.nets.encode(self._nchw(batch["x"]), "A", e, generator)
        return self._nhwc(self.nets.decode(z, "A"))
