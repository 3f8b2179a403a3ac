"""Adversarial tasks AEGAN and VAEGAN, and the discriminator helper of every
adversarial task (counterpart of ``vae_cyclegan_tpu/models/tasks/gan.py``).

Both alternate a generator update and a discriminator update: the generator
step differentiates G only (D sits in its graph but takes no gradient),
then the discriminator step runs on the detached fakes of the pre-update
generator. Spectral-norm bookkeeping follows the JAX package: AEGAN runs D
four times per step with updates (two in the generator step, two in the
discriminator step), threading the power-iteration state through them in
call order; VAEGAN keeps the state of its two generator-step calls, and its
discriminator step reruns D on the stored vectors (the reference reuses the
generator step's D outputs), then puts the kept state back.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from vae_cyclegan_tpu_torch import losses
from vae_cyclegan_tpu_torch.models.networks import (
    AutoencoderNet,
    Discriminator,
    VariationalAutoencoderNet,
)
from vae_cyclegan_tpu_torch.models.tasks.base import Task


def d_apply(disc: Discriminator, x: torch.Tensor,
            update: bool) -> torch.Tensor:
    """Apply a discriminator to an NCHW batch, returning its (B,) scores.
    With `update` the call runs one power iteration and advances the
    discriminator's spectral state; the JAX package returns that state as a
    new collection, here the module holds it, so the calls thread it in the
    order they are made."""
    return disc(x, update_stats=update)


class _GANTask(Task):
    """G and D, one Adam each."""

    #: the discriminator's init gain (AEGAN's composite re-initializes every
    #: child with the relu gain; VAEGAN leaves D at its own leaky_relu init)
    d_init = "relu"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.nets["G"] = self._generator()
        self.nets["D"] = Discriminator(
            self.mc.disc_final_kernel, self.mc.base_width,
            init_nonlinearity=self.d_init, **self._net_kw())
        self.gen_params = list(self.G.parameters())
        self.disc_params = list(self.D.parameters())
        self.opt_g = self._adam(self.gen_params)
        self.opt_d = self._adam(self.disc_params)

    @property
    def G(self):
        return self.nets["G"]

    @property
    def D(self) -> Discriminator:
        return self.nets["D"]

    def _generator(self) -> torch.nn.Module:
        raise NotImplementedError

    @torch.no_grad()
    def generate(self, batch, generator=None, eps=None) -> torch.Tensor:
        e = self._generate_eps(eps)
        return self._nhwc(self._gen(self.G, self._nchw(batch["x"]), e,
                                    generator)[0])


class AEGANTask(_GANTask):
    """G = Autoencoder. G step: L1(Gx, y) + lambda_gan * (MSE(Dy, 0) +
    MSE(DGx, 1)) + lambda_id * L1(Gy, y); D step on the detached Gx:
    MSE(Dy, 1) + MSE(DGx, 0)."""

    name = "aegan"

    def _generator(self):
        return AutoencoderNet(self.mc.base_width, **self._net_kw())

    def _g_losses(self, y, Gx, Gy, DGx, Dy):
        loss_trans = losses.translation_loss(Gx, y)
        gan_tot, gan_r, gan_f = losses.gan_loss_generator(Dy, DGx)
        loss_id = losses.translation_loss(Gy, y)
        g_loss = (loss_trans + self.lc.lambda_gan * gan_tot
                  + self.lc.lambda_identity * loss_id)
        return g_loss, loss_trans, (gan_tot, gan_r, gan_f), loss_id

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        self._eps(eps, self.train_passes)
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        Gx = self._gen(self.G, x, None, None)[0]
        Gy = self._gen(self.G, y, None, None)[0]
        DGx = d_apply(self.D, Gx, True)
        Dy = d_apply(self.D, y, True)
        g_loss, loss_trans, gan, loss_id = self._g_losses(y, Gx, Gy, DGx, Dy)
        nan_g = self._step(self.opt_g, g_loss, self.gen_params, batch)
        del Gy, DGx, Dy

        DGx_d = d_apply(self.D, Gx.detach(), True)
        Dy_d = d_apply(self.D, y, True)
        d_loss, d_real, d_fake = losses.gan_loss_discriminator(Dy_d, DGx_d)
        nan_d = self._step(self.opt_d, d_loss, self.disc_params, batch)
        return self._scalars({
            "G_loss": g_loss, "D_loss": d_loss, "D_loss_real": d_real,
            "D_loss_fake": d_fake, "loss_trans": loss_trans,
            "loss_gan_g": gan[0], "loss_identity": loss_id,
            "d_y_mean": Dy_d.mean(), "d_gx_mean": DGx_d.mean(),
        }, max(nan_g, nan_d))

    @torch.no_grad()
    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        self._eps(eps, self.eval_passes)
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        Gx, Gy = self.G(x), self.G(y)
        DGx, Dy = d_apply(self.D, Gx, False), d_apply(self.D, y, False)
        g_loss, loss_trans, gan, loss_id = self._g_losses(y, Gx, Gy, DGx, Dy)
        d_loss, d_real, d_fake = losses.gan_loss_discriminator(Dy, DGx)
        return {
            "total_loss": g_loss + d_loss, "G_loss": g_loss, "D_loss": d_loss,
            "D_loss_real": d_real, "D_loss_fake": d_fake,
            "loss_trans": loss_trans, "loss_gan_g": gan[0],
            "loss_gan_g_real": gan[1], "loss_gan_g_fake": gan[2],
            "loss_identity": loss_id, "Gx": self._nhwc(Gx),
        }


class VAEGANTask(_GANTask):
    """G = VariationalAutoencoder. G_loss = lambda_recon * L1(Gx, y) +
    lambda_gan * (MSE(Dy, 0) + MSE(DGx, 1)) + lambda_id * L1(Gy, y) +
    lambda_kl * KL; D loss MSE(Dy, 1) + MSE(DGx, 0) on the detached Gx, with
    D rerun on the generator step's stored spectral vectors."""

    name = "vaegan"
    d_init = "leaky_relu"
    train_passes = ("G(x)", "G(y)")

    def _generator(self):
        return VariationalAutoencoderNet(self.mc.latent_dim,
                                         self.mc.base_width, **self._net_kw())

    def _forward(self, x, y, eps, generator):
        Gx, mu, logvar = self._gen(self.G, x, eps[0], generator)
        Gy, _, _ = self._gen(self.G, y, eps[1], generator)
        return Gx, Gy, mu, logvar

    def _g_losses(self, y, Gx, Gy, mu, logvar, DGx, Dy):
        loss_trans = losses.translation_loss(Gx, y)
        gan_tot, gan_r, gan_f = losses.gan_loss_generator(Dy, DGx)
        loss_id = losses.translation_loss(Gy, y)
        loss_kl = losses.kl_divergence(mu, logvar)
        g_loss = (self.lc.lambda_recon * loss_trans
                  + self.lc.lambda_gan * gan_tot
                  + self.lc.lambda_identity * loss_id
                  + self.lc.lambda_kl * loss_kl)
        return g_loss, {"loss_trans": loss_trans, "loss_gan_real": gan_r,
                        "loss_gan_fake": gan_f, "loss_identity": loss_id,
                        "loss_kl": loss_kl}

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        Gx, Gy, mu, logvar = self._forward(
            x, y, self._eps(eps, self.train_passes), generator)
        sp0 = self.D.spectral_state()
        DGx = d_apply(self.D, Gx, True)
        sp1 = self.D.spectral_state()
        Dy = d_apply(self.D, y, True)
        sp2 = self.D.spectral_state()
        g_loss, parts = self._g_losses(y, Gx, Gy, mu, logvar, DGx, Dy)
        nan_g = self._step(self.opt_g, g_loss, self.gen_params, batch)
        del Gy, DGx, Dy

        # the same (u, v) chains as the generator step's calls: from sp0
        # for DGx and from sp1 for Dy; the state the step keeps is sp2
        self.D.set_spectral_state(sp0)
        DGx_d = d_apply(self.D, Gx.detach(), True)
        self.D.set_spectral_state(sp1)
        Dy_d = d_apply(self.D, y, True)
        self.D.set_spectral_state(sp2)
        d_loss, d_real, d_fake = losses.gan_loss_discriminator(Dy_d, DGx_d)
        nan_d = self._step(self.opt_d, d_loss, self.disc_params, batch)
        return self._scalars({
            "G_loss": g_loss, "D_loss": d_loss,
            "loss_gan_disc_real": d_real, "loss_gan_disc_fake": d_fake,
            **parts}, max(nan_g, nan_d))

    @torch.no_grad()
    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        Gx, Gy, mu, logvar = self._forward(
            x, y, self._eps(eps, self.eval_passes), generator)
        DGx, Dy = d_apply(self.D, Gx, False), d_apply(self.D, y, False)
        g_loss, parts = self._g_losses(y, Gx, Gy, mu, logvar, DGx, Dy)
        d_loss, _, _ = losses.gan_loss_discriminator(Dy, DGx)
        return {"total_loss": g_loss + d_loss, "G_loss": g_loss,
                "D_loss": d_loss, **parts, "Gx": self._nhwc(Gx)}
