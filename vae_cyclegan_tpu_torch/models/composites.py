"""Networks that share one encoder between two decoders (counterparts of
``vae_cyclegan_tpu/models/composites.py``): DoubleAENet and DoubleVAENet,
the pretraining nets whose shared encoder the Cycle architectures take
over. Submodule names are the reference's (``encoder``, ``decoder_A``,
``vae_encoder_block_B``, ...), so ``state_dict`` keys match the keys
``vae_cyclegan_tpu/utils/torch_import.py`` maps.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vae_cyclegan_tpu_torch.models.networks import (
    Decoder,
    Encoder,
    VariationalDecoderBlock,
    VariationalEncoderBlock,
)


class DoubleAENet(nn.Module):
    """Shared Encoder + decoder_A + decoder_B. forward(x, y) -> (Gx, Gy),
    each modality reconstructed through its own decoder; the translate_*
    methods give the cross translations."""

    def __init__(self, base_width: int = 64,
                 dtype: Optional[torch.dtype] = None, device=None,
                 instance_norm: str = "auto"):
        super().__init__()
        self.encoder = Encoder(base_width, dtype, device, instance_norm)
        self.decoder_A = Decoder(base_width, 3, dtype, device, instance_norm)
        self.decoder_B = Decoder(base_width, 3, dtype, device, instance_norm)

    def forward(self, x: torch.Tensor, y: torch.Tensor):
        return self.decoder_A(self.encoder(x)), self.decoder_B(self.encoder(y))

    def translate_A_to_B(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder_B(self.encoder(x))

    def translate_B_to_A(self, y: torch.Tensor) -> torch.Tensor:
        return self.decoder_A(self.encoder(y))


class DoubleVAENet(nn.Module):
    """Shared Encoder + a VAE block pair and a decoder per modality.
    forward(x, y) -> (Gx, Gy, mu_x, logvar_x, mu_y, logvar_y). Each
    variational pass takes its own noise `eps` (NCHW) or draws it from
    `generator`, as ``networks.VariationalEncoderBlock``."""

    def __init__(self, latent_dim: int = 64, base_width: int = 64,
                 dtype: Optional[torch.dtype] = None, device=None,
                 instance_norm: str = "auto"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.encoder = Encoder(base_width, dtype, device, instance_norm)
        self.vae_encoder_block_A = VariationalEncoderBlock(
            base_width * 16, latent_dim, **kw)
        self.vae_encoder_block_B = VariationalEncoderBlock(
            base_width * 16, latent_dim, **kw)
        self.vae_decoder_block_A = VariationalDecoderBlock(
            latent_dim, base_width * 16, **kw)
        self.vae_decoder_block_B = VariationalDecoderBlock(
            latent_dim, base_width * 16, **kw)
        self.decoder_A = Decoder(base_width, 3, dtype, device, instance_norm)
        self.decoder_B = Decoder(base_width, 3, dtype, device, instance_norm)

    def encode(self, v, side: str, eps, generator):
        """The shared encoder, then side "A"'s or "B"'s VAE encoder block:
        (z, mu, logvar)."""
        return getattr(self, f"vae_encoder_block_{side}")(
            self.encoder(v), eps, generator)

    def decode(self, z, side: str) -> torch.Tensor:
        return getattr(self, f"decoder_{side}")(
            getattr(self, f"vae_decoder_block_{side}")(z))

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                eps_x: Optional[torch.Tensor] = None,
                eps_y: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        z_x, mu_x, logvar_x = self.encode(x, "A", eps_x, generator)
        z_y, mu_y, logvar_y = self.encode(y, "B", eps_y, generator)
        return (self.decode(z_x, "A"), self.decode(z_y, "B"), mu_x,
                logvar_x, mu_y, logvar_y)

    def translate_A_to_B(self, x: torch.Tensor,
                         eps: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        return self.decode(self.encode(x, "B", eps, generator)[0], "B")

    def translate_B_to_A(self, y: torch.Tensor,
                         eps: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        return self.decode(self.encode(y, "A", eps, generator)[0], "A")
