"""Networks of the generator (counterparts of
``vae_cyclegan_tpu/models/networks.py``), NCHW. Shapes at image_size=256:

  Encoder:     (B, 3, 256, 256)  -> (B, 1024, 16, 16)
  Decoder:     (B, 1024, 16, 16) -> (B, 3, 256, 256)   [unbounded output]
  VarEncBlock: (B, 1024, 16, 16) -> z/mu/logvar (B, latent_dim, 16, 16)
  VarDecBlock: (B, latent_dim, 16, 16) -> (B, 1024, 16, 16)

Submodule names follow the reference's torch modules (``model.0``,
``muConv``, ``logvarConv.1``, ...), so ``state_dict`` keys match the keys
``vae_cyclegan_tpu/utils/torch_import.py`` maps. SpectralConv and the
Discriminator come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from vae_cyclegan_tpu_torch.models.blocks import (
    CaSb,
    DBlock,
    LConv,
    RBlock,
    SConv,
    UBlock,
)


class Encoder(nn.Module):
    """CaSb(3->w, k7) -> D x4 (w->2w->4w->8w->16w) -> R(16w)."""

    def __init__(self, base_width: int = 64,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        w = base_width
        kw = dict(dtype=dtype, device=device)
        self.model = nn.Sequential(
            CaSb(3, w, 7, 1, 3, **kw),
            DBlock(w, w * 2, **kw),
            DBlock(w * 2, w * 4, **kw),
            DBlock(w * 4, w * 8, **kw),
            DBlock(w * 8, w * 16, **kw),
            RBlock(w * 16, **kw),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class Decoder(nn.Module):
    """R(16w) -> U x4 (16w->8w->4w->2w->w) -> CaSb(w->3, k7, Identity, no
    norm). The output is unbounded; callers clip for display."""

    def __init__(self, base_width: int = 64, out_channels: int = 3,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        w = base_width
        kw = dict(dtype=dtype, device=device)
        self.model = nn.Sequential(
            RBlock(w * 16, **kw),
            UBlock(w * 16, w * 8, **kw),
            UBlock(w * 8, w * 4, **kw),
            UBlock(w * 4, w * 2, **kw),
            UBlock(w * 2, w, **kw),
            CaSb(w, out_channels, 7, 1, 3, activation="Identity",
                 use_norm=False, **kw),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class VariationalEncoderBlock(nn.Module):
    """mu = L(x); logvar = clip(S(S(x)), -10, 10); z = mu + eps * exp(logvar/2).

    z is computed in float32 and cast to mu's dtype. The noise is `eps`
    (NCHW, the shape of mu) when given, else drawn from `generator` (or the
    default generator of mu's device) — sampled in every mode, as the
    reference does."""

    def __init__(self, in_channels: int, latent_dim: int = 64,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.muConv = LConv(in_channels, latent_dim, **kw)
        self.logvarConv = nn.Sequential(
            SConv(in_channels, latent_dim, **kw),
            SConv(latent_dim, latent_dim, **kw),
        )

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mu = self.muConv(x)
        logvar = torch.clamp(self.logvarConv(x), -10.0, 10.0)
        std = torch.exp(0.5 * logvar.float())
        if eps is None:
            eps = torch.randn(std.shape, generator=generator,
                              device=std.device, dtype=torch.float32)
        elif tuple(eps.shape) != tuple(std.shape):
            raise ValueError(f"eps shape {tuple(eps.shape)} != latent shape "
                             f"{tuple(std.shape)}")
        z = mu.float() + eps.to(std.device, torch.float32) * std
        return z.to(mu.dtype), mu, logvar


class VariationalDecoderBlock(nn.Module):
    """One S conv projecting z (latent) back to `out_channels`."""

    def __init__(self, latent_dim: int = 64, out_channels: int = 1024,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.conv = SConv(latent_dim, out_channels, dtype=dtype, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.conv(z)


class AutoencoderNet(nn.Module):
    """Encoder -> Decoder."""

    def __init__(self, base_width: int = 64,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.encoder = Encoder(base_width, dtype, device)
        self.decoder = Decoder(base_width, 3, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))


class VariationalAutoencoderNet(nn.Module):
    """Encoder -> VarEncBlock -> VarDecBlock -> Decoder; returns
    (Gx, mu, logvar)."""

    def __init__(self, latent_dim: int = 64, base_width: int = 64,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.encoder = Encoder(base_width, dtype, device)
        self.variational_encoder_block = VariationalEncoderBlock(
            base_width * 16, latent_dim, dtype, device)
        self.variational_decoder_block = VariationalDecoderBlock(
            latent_dim, base_width * 16, dtype, device)
        self.decoder = Decoder(base_width, 3, dtype, device)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        encoded = self.encoder(x)
        z, mu, logvar = self.variational_encoder_block(encoded, eps, generator)
        Gx = self.decoder(self.variational_decoder_block(z))
        return Gx, mu, logvar
