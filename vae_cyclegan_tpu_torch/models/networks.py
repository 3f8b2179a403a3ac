"""Networks (counterparts of ``vae_cyclegan_tpu/models/networks.py``), NCHW.
Shapes at image_size=256:

  Encoder:       (B, 3, 256, 256)  -> (B, 1024, 16, 16)
  Decoder:       (B, 1024, 16, 16) -> (B, 3, 256, 256)   [unbounded output]
  VarEncBlock:   (B, 1024, 16, 16) -> z/mu/logvar (B, latent_dim, 16, 16)
  VarDecBlock:   (B, latent_dim, 16, 16) -> (B, 1024, 16, 16)
  Discriminator: (B, 3, 256, 256)  -> (B,)  one scalar per image (a global
                 discriminator whose final kernel covers the whole 16x16 map)

Submodule names follow the reference's torch modules (``model.0``,
``muConv``, ``logvarConv.1``, ``model.4.weight_orig``, ...), so
``state_dict`` keys match the keys ``vae_cyclegan_tpu/utils/torch_import.py``
maps. ``instance_norm`` is the configuration's InstanceNorm mode, passed to
every block (``ModelConfig.instance_norm``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vae_cyclegan_tpu_torch.models.blocks import (
    CaSb,
    DBlock,
    LConv,
    RBlock,
    SConv,
    UBlock,
)
from vae_cyclegan_tpu_torch.ops import kaiming_normal_fan_out, spectral_normalize
from vae_cyclegan_tpu_torch.ops.starved_conv import supported
from vae_cyclegan_tpu_torch.parallel import dp, spatial


class Encoder(nn.Module):
    """CaSb(3->w, k7) -> D x4 (w->2w->4w->8w->16w) -> R(16w)."""

    def __init__(self, base_width: int = 64,
                 dtype: Optional[torch.dtype] = None, device=None,
                 instance_norm: str = "auto"):
        super().__init__()
        w = base_width
        kw = dict(dtype=dtype, device=device, instance_norm=instance_norm)
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
    norm). The output is unbounded; callers clip for display.

    Under "tiled", U4's InstanceNorm takes the plain version wherever the
    JAX package hands U4 -> IN -> tail over channel-major: when both U4's
    conv and the tail's are starved-conv shapes (its ``cm_engaged``, here
    ``starved_conv.supported``, on shapes alone, so the same on every
    device). JAX normalizes that site on XLA. Under "auto" the slab rule
    decides that site, as it always has (at full width it is plain either
    way)."""

    def __init__(self, base_width: int = 64, out_channels: int = 3,
                 dtype: Optional[torch.dtype] = None, device=None,
                 instance_norm: str = "auto"):
        super().__init__()
        w = base_width
        self.dtype = dtype
        self.instance_norm = instance_norm
        kw = dict(dtype=dtype, device=device, instance_norm=instance_norm)
        self.model = nn.Sequential(
            RBlock(w * 16, **kw),
            UBlock(w * 16, w * 8, **kw),
            UBlock(w * 8, w * 4, **kw),
            UBlock(w * 4, w * 2, **kw),
            UBlock(w * 2, w, **kw),
            CaSb(w, out_channels, 7, 1, 3, activation="Identity",
                 use_norm=False, **kw),
        )

    def _u4_norm(self, x: torch.Tensor) -> str:
        """U4's InstanceNorm mode for U4's input x (before its shuffle)."""
        if self.instance_norm != "tiled":
            return self.instance_norm
        u4, tail = self.model[4].conv.weight, self.model[5].conv.weight
        n, _, h, w = x.shape
        h *= spatial.spatial_size()  # the global shape decides
        dtype = self.dtype or x.dtype
        cm = (supported((n, u4.shape[1], 2 * h, 2 * w), u4.shape, dtype)
              and supported((n, tail.shape[1], 2 * h, 2 * w), tail.shape,
                            dtype))
        return "plain" if cm else "tiled"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.model[:4]:
            x = block(x)
        x = self.model[4](x, self._u4_norm(x))
        return self.model[5](x)


class VariationalEncoderBlock(nn.Module):
    """mu = L(x); logvar = clip(S(S(x)), -10, 10); z = mu + eps * exp(logvar/2).

    z is computed in float32 and cast to mu's dtype. The noise is `eps`
    (NCHW, the shape of mu) when given, else drawn from `generator` (or the
    default generator of mu's device; the global batch's draw sliced to this
    rank's rows in a data-parallel step, ``parallel.dp.dp_normal``) —
    sampled in every mode, as the reference does."""

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
            eps = dp.dp_normal(generator, std.shape, std.device)
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
                 dtype: Optional[torch.dtype] = None, device=None,
                 instance_norm: str = "auto"):
        super().__init__()
        self.encoder = Encoder(base_width, dtype, device, instance_norm)
        self.decoder = Decoder(base_width, 3, dtype, device, instance_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))


class VariationalAutoencoderNet(nn.Module):
    """Encoder -> VarEncBlock -> VarDecBlock -> Decoder; returns
    (Gx, mu, logvar)."""

    def __init__(self, latent_dim: int = 64, base_width: int = 64,
                 dtype: Optional[torch.dtype] = None, device=None,
                 instance_norm: str = "auto"):
        super().__init__()
        self.encoder = Encoder(base_width, dtype, device, instance_norm)
        self.variational_encoder_block = VariationalEncoderBlock(
            base_width * 16, latent_dim, dtype, device)
        self.variational_decoder_block = VariationalDecoderBlock(
            latent_dim, base_width * 16, dtype, device)
        self.decoder = Decoder(base_width, 3, dtype, device, instance_norm)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        encoded = self.encoder(x)
        z, mu, logvar = self.variational_encoder_block(encoded, eps, generator)
        Gx = self.decoder(self.variational_decoder_block(z))
        return Gx, mu, logvar


def _unit_normal(n: int, generator: torch.Generator) -> torch.Tensor:
    g = torch.randn(n, generator=generator, dtype=torch.float32)
    return g / (torch.linalg.vector_norm(g) + 1e-12)


class SpectralConv(nn.Module):
    """VALID conv whose weight is spectrally normalized (the reference's
    ``spectral_norm(nn.Conv2d(512, 1, 16))``), with torch's names: the
    ``bias`` and ``weight_orig`` parameters (in that order, as
    ``spectral_norm`` leaves them) and the ``weight_u`` (cout,) and
    ``weight_v`` (cin * k * k, over (I, kH, kW)) buffers.

    A training call (``update_stats=True``) runs one power iteration and
    replaces the buffers with the new vectors as fresh tensors, so the
    spectral state threads through the calls in call order; an evaluation
    call reads them.

    Under spatial parallelism the kernel covers the whole map, so each rank
    convolves its rows with its rows of the normalized weight, the partials
    are summed over the spatial group (``parallel.spatial.spatial_sum``) and
    the bias is added once. The power iteration stays replicated."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 dtype: Optional[torch.dtype] = None, device=None,
                 kernel_init_nonlinearity: str = "leaky_relu"):
        super().__init__()
        self.dtype = dtype
        self.kernel_init_nonlinearity = kernel_init_nonlinearity
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.weight_orig = nn.Parameter(torch.empty(
            features, cin, kernel_size, kernel_size, device=device))
        self.register_buffer("weight_u", torch.empty(features, device=device))
        self.register_buffer("weight_v", torch.empty(
            cin * kernel_size * kernel_size, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-normal fan_out weight (the gain of
        `kernel_init_nonlinearity`), zero bias, unit-normal u and v, drawn
        from `generator` in that order."""
        self.weight_orig.copy_(kaiming_normal_fan_out(
            self.weight_orig.shape, generator, self.kernel_init_nonlinearity))
        self.bias.zero_()
        self.weight_u.copy_(_unit_normal(self.weight_u.numel(), generator))
        self.weight_v.copy_(_unit_normal(self.weight_v.numel(), generator))

    def forward(self, x: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        w_sn, u, v = spectral_normalize(self.weight_orig, self.weight_u,
                                        self.weight_v, update_stats)
        if update_stats:
            self.weight_u, self.weight_v = u, v
        dtype = self.dtype or x.dtype
        lay = spatial.current()
        if lay is not None:
            h = x.shape[2]
            if h * lay.size != w_sn.shape[2]:
                spatial.refuse("the discriminator's spectral conv", h,
                               f"{w_sn.shape[2] // lay.size} (its kernel's "
                               "rows over the group)")
            w_sn = w_sn[:, :, lay.rank * h:(lay.rank + 1) * h]
            y = spatial.spatial_sum(F.conv2d(x.to(dtype), w_sn.to(dtype)))
        else:
            y = F.conv2d(x.to(dtype), w_sn.to(dtype))
        return y + self.bias.to(dtype)[:, None, None]


class Discriminator(nn.Module):
    """4x CaSb(k4, s2, reflect pad 1, LeakyReLU) 3->w->2w->4w->8w (the first
    without norm) -> SpectralConv(8w->1, k=final_kernel) -> (B,).

    ``final_kernel`` is ``image_size // 16``. Every conv weight is drawn
    Kaiming-normal with the gain of `init_nonlinearity`: the reference's own
    leaky_relu (a = 0.2), which VAEGAN keeps, or relu, which the composites
    that re-initialize all their children (AEGAN, CycleAEGAN, CycleVAEGAN)
    give it."""

    def __init__(self, final_kernel: int = 16, base_width: int = 64,
                 dtype: Optional[torch.dtype] = None, device=None,
                 init_nonlinearity: str = "leaky_relu",
                 instance_norm: str = "auto"):
        super().__init__()
        w = base_width
        common = dict(kernel_size=4, stride=2, padding=1,
                      activation="LeakyReLU", dtype=dtype, device=device,
                      kernel_init_nonlinearity=init_nonlinearity,
                      instance_norm=instance_norm)
        self.model = nn.Sequential(
            CaSb(3, w, use_norm=False, **common),
            CaSb(w, w * 2, **common),
            CaSb(w * 2, w * 4, **common),
            CaSb(w * 4, w * 8, **common),
            SpectralConv(w * 8, 1, final_kernel, dtype, device,
                         init_nonlinearity),
        )

    def forward(self, x: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        for block in self.model[:4]:
            x = block(x)
        x = self.model[4](x, update_stats)
        return x.reshape(x.shape[0])

    def spectral_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The power-iteration vectors (u, v) as they stand. A training call
        replaces them with fresh tensors, so the pair stays as it was."""
        sc = self.model[4]
        return sc.weight_u, sc.weight_v

    def set_spectral_state(self, state: Tuple[torch.Tensor,
                                              torch.Tensor]) -> None:
        """Put back a pair that ``spectral_state`` returned."""
        sc = self.model[4]
        sc.weight_u, sc.weight_v = state
