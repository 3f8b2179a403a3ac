"""Atomic loss functions (counterpart of ``vae_cyclegan_tpu/losses.py``),
formula-exact with the reference. Every reduction is a full-tensor mean in
float32; which terms enter G_loss and D_loss is the task's business.

Quirks kept, as in the JAX package:
  * ``gan_loss_generator`` includes the MSE(D_real, 0) term the generator
    cannot influence; CycleVAEGAN alone leaves it out of G_loss.
  * ``kl_divergence`` is a mean over every element, not a per-sample sum,
    with logvar clamped to [-10, 10].
"""

from __future__ import annotations

from typing import Tuple

import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).square().mean()


def translation_loss(generated: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """L_trans = ||generated - target||_1 (mean)."""
    return l1_loss(generated, target)


def cycle_consistency_loss(x: torch.Tensor, y: torch.Tensor,
                           FGx: torch.Tensor,
                           GFy: torch.Tensor) -> torch.Tensor:
    """L_cycle = ||F(G(x)) - x||_1 + ||G(F(y)) - y||_1."""
    return l1_loss(FGx, x) + l1_loss(GFy, y)


def identity_loss(x: torch.Tensor, y: torch.Tensor, Fx: torch.Tensor,
                  Gy: torch.Tensor) -> torch.Tensor:
    """L_id = ||F(x) - x||_1 + ||G(y) - y||_1."""
    return l1_loss(Fx, x) + l1_loss(Gy, y)


def gan_loss_generator(d_real: torch.Tensor, d_fake: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LSGAN generator loss MSE(D_real, 0) + MSE(D_fake, 1); returns
    (total, real term, fake term)."""
    real = mse_loss(d_real, torch.zeros_like(d_real))
    fake = mse_loss(d_fake, torch.ones_like(d_fake))
    return real + fake, real, fake


def gan_loss_discriminator(d_real: torch.Tensor, d_fake: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """LSGAN discriminator loss MSE(D_real, 1) + MSE(D_fake, 0); returns
    (total, real term, fake term)."""
    real = mse_loss(d_real, torch.ones_like(d_real))
    fake = mse_loss(d_fake, torch.zeros_like(d_fake))
    return real + fake, real, fake


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)) = -0.5 * mean(1 + logvar - mu^2 - exp(logvar)),
    logvar clamped to [-10, 10]."""
    lv = logvar.float().clamp(-10.0, 10.0)
    m = mu.float()
    return -0.5 * (1.0 + lv - m.square() - lv.exp()).mean()
