"""Adversarial cycle tasks (counterpart of
``vae_cyclegan_tpu/models/tasks/cyclegan.py``): the flagship CycleVAEGAN,
with two variational generators G (X -> Y) and F (Y -> X) and two
discriminators DX and DY.

Per training step: 6 generator forwards (two full cycles and two identity
passes) and 8 discriminator forwards, 4 in the generator step's graph and 4
on the detached fakes of the pre-update generators. One Adam covers F+G, one
DX+DY. The generator step differentiates G and F only: DX and DY sit in its
graph but take no gradient there. CycleVAEGAN's G_loss keeps only the fake
half of the generator GAN loss, and its 'loss_gan_g' metric reports that
half. CycleAEGAN (autoencoder generators, the real+fake total) is still to
port.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from vae_cyclegan_tpu_torch import losses
from vae_cyclegan_tpu_torch.models.networks import (
    Discriminator,
    VariationalAutoencoderNet,
)
from vae_cyclegan_tpu_torch.models.tasks.base import Task
from vae_cyclegan_tpu_torch.models.tasks.gan import d_apply

#: the generator passes of one step, in the reference's order; train_step's
#: and eval_step's `eps` lists follow it
GEN_PASSES = ("G(x)", "G(y)", "F(Gx)", "F(y)", "F(x)", "G(Fy)")


class _CycleGANBase(Task):
    """Structure of the cycle-GAN tasks with variational generators."""

    has_fy = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        kw = dict(dtype=self.mc.dtype, device=self.device)
        for key in ("G", "F"):
            self.nets[key] = VariationalAutoencoderNet(
                self.mc.latent_dim, self.mc.base_width, **kw)
        for key in ("DX", "DY"):
            self.nets[key] = Discriminator(self.mc.disc_final_kernel,
                                           self.mc.base_width, **kw)
        # the reference's optimizer order: Adam(F + G), Adam(DX + DY)
        self.gen_params = list(self.F.parameters()) + list(self.G.parameters())
        self.disc_params = (list(self.DX.parameters())
                            + list(self.DY.parameters()))
        self.opt_g = self._adam(self.gen_params)
        self.opt_d = self._adam(self.disc_params)

    @property
    def G(self) -> VariationalAutoencoderNet:
        return self.nets["G"]

    @property
    def F(self) -> VariationalAutoencoderNet:
        return self.nets["F"]

    @property
    def DX(self) -> Discriminator:
        return self.nets["DX"]

    @property
    def DY(self) -> Discriminator:
        return self.nets["DY"]

    # -- generator passes --------------------------------------------------

    def _eps(self, eps: Optional[List]) -> List[Optional[torch.Tensor]]:
        """Six NHWC noise tensors (GEN_PASSES order) as NCHW on the device,
        or six Nones (the networks then draw from the generator)."""
        if eps is None:
            return [None] * len(GEN_PASSES)
        if len(eps) != len(GEN_PASSES):
            raise ValueError(f"eps: {len(eps)} tensors, expected "
                             f"{len(GEN_PASSES)} ({', '.join(GEN_PASSES)})")
        return [self._nchw(e) for e in eps]

    def _gen_forward(self, x, y, eps, generator):
        """G(x), G(y), F(Gx), F(y), F(x), G(Fy), and the KL terms."""
        G, F = self.G, self.F
        Gx, mu_x, lv_x = G(x, eps[0], generator)
        Gy, _, _ = G(y, eps[1], generator)
        FGx, mu_FGx, lv_FGx = F(Gx, eps[2], generator)
        Fy, mu_y, lv_y = F(y, eps[3], generator)
        Fx, _, _ = F(x, eps[4], generator)
        GFy, mu_GFy, lv_GFy = G(Fy, eps[5], generator)
        kl_terms = (mu_x, lv_x, mu_FGx, lv_FGx, mu_y, lv_y, mu_GFy, lv_GFy)
        return Gx, Gy, FGx, Fy, Fx, GFy, kl_terms

    def _kl(self, kl_terms):
        mu_x, lv_x, mu_FGx, lv_FGx, mu_y, lv_y, mu_GFy, lv_GFy = kl_terms
        return (losses.kl_divergence(mu_x, lv_x)
                + losses.kl_divergence(mu_FGx, lv_FGx)
                + losses.kl_divergence(mu_y, lv_y)
                + losses.kl_divergence(mu_GFy, lv_GFy))

    def _g_losses(self, x, y, gens, d_scores):
        """G_loss and its parts from the generator outputs and the four
        discriminator scores (DY(Gx), DX(Fy), DX(x), DY(y))."""
        Gx, Gy, FGx, Fy, Fx, GFy, kl_terms = gens
        DYGx, DXFy, DXx, DYy = d_scores
        loss_cycle = losses.cycle_consistency_loss(x, y, FGx, GFy)
        gan_parts = (*losses.gan_loss_generator(DXx, DXFy),
                     *losses.gan_loss_generator(DYy, DYGx))
        loss_kl = self._kl(kl_terms)
        loss_identity = (losses.identity_loss(x, y, Fx, Gy) if self.paired
                         else None)
        g_loss = self._g_total(loss_cycle, gan_parts, loss_kl, loss_identity)
        return g_loss, loss_cycle, gan_parts, loss_kl, loss_identity

    def _metrics(self, g_loss, d_loss, d_parts, loss_cycle, gan_parts,
                 loss_kl, loss_identity) -> Dict[str, torch.Tensor]:
        d_x_real, d_x_fake, d_y_real, d_y_fake = d_parts
        (_, gan_g_x_real, gan_g_x_fake, _, gan_g_y_real,
         gan_g_y_fake) = gan_parts
        metrics = {
            "total_loss": g_loss + d_loss,
            "G_loss": g_loss,
            "D_loss": d_loss,
            "D_loss_x_real": d_x_real,
            "D_loss_x_fake": d_x_fake,
            "D_loss_y_real": d_y_real,
            "D_loss_y_fake": d_y_fake,
            "loss_cycle": loss_cycle,
            "loss_gan_g": self._gan_g_metric(gan_parts),
            "loss_gan_g_x_real": gan_g_x_real,
            "loss_gan_g_x_fake": gan_g_x_fake,
            "loss_gan_g_y_real": gan_g_y_real,
            "loss_gan_g_y_fake": gan_g_y_fake,
            "loss_kl": loss_kl,
        }
        if self.paired:
            metrics["loss_identity"] = loss_identity
        return metrics

    # -- protocol ----------------------------------------------------------

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One alternating step: G+F on the generator losses, then DX+DY on
        the detached fakes of the pre-update generators. batch["x"] and
        batch["y"] are (B, S, S, 3) NHWC. `eps` is an optional list of six
        NHWC noise tensors (B, S/16, S/16, latent_dim) in GEN_PASSES order;
        otherwise the noise is drawn from `generator` (or the device's
        default one). Returns the reference's metrics as 0-d f32 tensors on
        the device, with 'nan_detected' 1.0 when an update was skipped."""
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        gens = self._gen_forward(x, y, self._eps(eps), generator)
        Gx, Fy = gens[0], gens[3]
        # in-graph D calls, reference order: DY(Gx), DX(Fy), DX(x), DY(y)
        d_scores = (d_apply(self.DY, Gx, True), d_apply(self.DX, Fy, True),
                    d_apply(self.DX, x, True), d_apply(self.DY, y, True))
        g_loss, loss_cycle, gan_parts, loss_kl, loss_identity = (
            self._g_losses(x, y, gens, d_scores))
        grads_g = torch.autograd.grad(g_loss, self.gen_params)
        nan_g = self._finite_update(self.opt_g, g_loss, self.gen_params,
                                    grads_g)
        del gens, d_scores, grads_g

        # detached D calls, reference order: DY(Gx), DX(Fy), DX(x), DY(y)
        Gx, Fy = Gx.detach(), Fy.detach()
        DYGx = d_apply(self.DY, Gx, True)
        DXFy = d_apply(self.DX, Fy, True)
        DXx = d_apply(self.DX, x, True)
        DYy = d_apply(self.DY, y, True)
        gan_d_x, d_x_real, d_x_fake = losses.gan_loss_discriminator(DXx, DXFy)
        gan_d_y, d_y_real, d_y_fake = losses.gan_loss_discriminator(DYy, DYGx)
        d_loss = gan_d_x + gan_d_y
        grads_d = torch.autograd.grad(d_loss, self.disc_params)
        nan_d = self._finite_update(self.opt_d, d_loss, self.disc_params,
                                    grads_d)

        metrics = self._metrics(g_loss, d_loss,
                                (d_x_real, d_x_fake, d_y_real, d_y_fake),
                                loss_cycle, gan_parts, loss_kl, loss_identity)
        metrics.update({
            "d_x_real_mean": DXx.mean(),
            "d_x_fake_mean": DXFy.mean(),
            "d_y_real_mean": DYy.mean(),
            "d_y_fake_mean": DYGx.mean(),
        })
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        metrics["nan_detected"] = torch.tensor(max(nan_g, nan_d),
                                               device=self.device)
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        """The step's losses without updates or spectral iterations, plus
        the images 'Gx' and 'Fy' (NHWC, compute dtype). `eps` and
        `generator` as in train_step."""
        x, y = self._nchw(batch["x"]), self._nchw(batch["y"])
        gens = self._gen_forward(x, y, self._eps(eps), generator)
        Gx, Fy = gens[0], gens[3]
        DYGx, DXFy = d_apply(self.DY, Gx, False), d_apply(self.DX, Fy, False)
        DXx, DYy = d_apply(self.DX, x, False), d_apply(self.DY, y, False)
        g_loss, loss_cycle, gan_parts, loss_kl, loss_identity = (
            self._g_losses(x, y, gens, (DYGx, DXFy, DXx, DYy)))
        gan_d_x, d_x_real, d_x_fake = losses.gan_loss_discriminator(DXx, DXFy)
        gan_d_y, d_y_real, d_y_fake = losses.gan_loss_discriminator(DYy, DYGx)
        metrics = self._metrics(g_loss, gan_d_x + gan_d_y,
                                (d_x_real, d_x_fake, d_y_real, d_y_fake),
                                loss_cycle, gan_parts, loss_kl, loss_identity)
        metrics["Gx"] = Gx.permute(0, 2, 3, 1)
        metrics["Fy"] = Fy.permute(0, 2, 3, 1)
        return metrics

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

    def _g_total(self, loss_cycle, gan_parts, loss_kl, loss_identity):
        """Per-architecture G_loss assembly."""
        raise NotImplementedError

    def _gan_g_metric(self, gan_parts):
        raise NotImplementedError


class CycleVAEGANTask(_CycleGANBase):
    """The flagship. G_loss = lambda_cycle*cycle + lambda_gan*(fake terms
    only) + lambda_kl*KL [+ lambda_id*identity when paired]."""

    name = "cyclevaegan"

    def _g_total(self, loss_cycle, gan_parts, loss_kl, loss_identity):
        _, _, gan_g_x_fake, _, _, gan_g_y_fake = gan_parts
        g_loss = (self.lc.lambda_cycle * loss_cycle
                  + self.lc.lambda_gan * (gan_g_x_fake + gan_g_y_fake)
                  + self.lc.lambda_kl * loss_kl)
        if self.paired:
            g_loss = g_loss + self.lc.lambda_identity * loss_identity
        return g_loss

    def _gan_g_metric(self, gan_parts):
        _, _, gan_g_x_fake, _, _, gan_g_y_fake = gan_parts
        return gan_g_x_fake + gan_g_y_fake
