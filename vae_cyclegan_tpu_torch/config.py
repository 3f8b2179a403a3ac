"""Configuration dataclasses for models, optimizers and losses.

Counterpart of ``vae_cyclegan_tpu/config.py`` with torch dtypes. The JAX
config's ``use_pallas`` and ``remat`` have no counterpart: on the card the
dispatch rules choose the kernels, and rematerialization
(``torch.utils.checkpoint``) waits until a batch needs it (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture configuration.

    Attributes:
      image_size: spatial side of the (square) input images (256 in the
        reference; the discriminator's final kernel is ``image_size // 16``).
      latent_dim: channels of the spatial VAE latent, (B, latent_dim,
        image_size / 16, image_size / 16) in NCHW.
      base_width: channels of the first encoder conv (64 in the reference).
      dtype: compute dtype of the convs. Parameters stay float32;
        normalization statistics are always computed in float32.
    """

    image_size: int = 256
    latent_dim: int = 64
    base_width: int = 64
    dtype: torch.dtype = torch.float32

    @property
    def disc_final_kernel(self) -> int:
        k = self.image_size // 16
        if k < 1:
            raise ValueError(f"image_size {self.image_size} too small (min 16)")
        return k


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Adam settings (reference defaults)."""

    lr: float = 2e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference defaults)."""

    lambda_kl: float = 1e-5
    lambda_gan: float = 1.0
    lambda_identity: float = 5.0
    lambda_cycle: float = 10.0
    lambda_recon: float = 1.0
