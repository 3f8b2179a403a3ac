"""Configuration dataclasses for models, optimizers and losses.

Counterpart of ``vae_cyclegan_tpu/config.py`` with torch dtypes. The JAX
config's ``use_pallas`` becomes ``instance_norm`` (``instance_norm_mode``
maps one onto the other); its ``remat`` is ``remat`` here too: the training
steps recompute each generator pass in its backward
(``torch.utils.checkpoint``, ``Task._maybe_remat``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

#: the InstanceNorm paths a configuration can choose (ops/instance_norm.py)
INSTANCE_NORM_MODES = ("auto", "tiled")


def instance_norm_mode(use_pallas: Optional[Union[bool, str]]) -> str:
    """The port's ``ModelConfig.instance_norm`` for a JAX ``use_pallas``
    value: None and True are "auto" (on the TPU both take the one-pass
    kernel where the slab fits), "tiled" is "tiled". False, which turns
    every kernel off, has no counterpart."""
    if use_pallas is None or use_pallas is True:
        return "auto"
    if use_pallas == "tiled":
        return "tiled"
    if use_pallas is False:
        raise NotImplementedError(
            "use_pallas=False (every kernel off) has no counterpart in the "
            "port: ROADMAP.md, 'Modules to port', item 10")
    raise ValueError(f"unknown use_pallas value {use_pallas!r}")


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
      instance_norm: "auto" (the one-pass kernel where a sample's slab is at
        most 1 MB, the plain version above) or "tiled" (the two-pass kernel
        at every InstanceNorm site but the Decoder's channel-major U4).
      remat: recompute every generator pass of a training step in its
        backward instead of keeping its activations (JAX's ``remat``, the
        same passes): less device memory, one more generator forward per
        pass.
    """

    image_size: int = 256
    latent_dim: int = 64
    base_width: int = 64
    dtype: torch.dtype = torch.float32
    instance_norm: str = "auto"
    remat: bool = False

    def __post_init__(self):
        if self.instance_norm not in INSTANCE_NORM_MODES:
            raise ValueError(f"instance_norm must be one of "
                             f"{INSTANCE_NORM_MODES}, got {self.instance_norm!r}")

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
