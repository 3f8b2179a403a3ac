"""Plain PyTorch networks of Cycle-VAE-GAN and VAE-GAN
(``Baverne/VAE-CYCLEGAN-Implementation``, ``Networks.py``), in float32.

Every conv is a reflect pad and ``F.conv2d``, every InstanceNorm
``F.instance_norm`` (biased variance, eps 1e-5, no affine), every
(un)shuffle ``F.pixel_(un)shuffle``, and the discriminator's last conv is
spectrally normalised by one power iteration per training call, as
``torch.nn.utils.spectral_norm`` does. Module and parameter names follow the
published ``state_dict`` keys (``encoder.model.0.conv.weight``,
``variational_encoder_block.muConv.conv.weight``, ``model.4.weight_orig``),
so one dict of weights loads into these modules and into the program's.

``Precision`` decides what the networks compute in: float32 (the
reference), or float8 e4m3 with a per-tensor scale (the control that a
lower precision must fail), rounding every tensor the program keeps in
bfloat16 to float8 instead: each conv's operands and result, each
InstanceNorm's activated output, each residual sum and the latent sample.
Normalisation statistics, losses and the optimizer stay float32, as in the
program.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

IN_EPS = 1e-5
LEAKY_SLOPE = 0.2
FP8_MAX = 448.0


class Precision:
    """The precision of every conv's operands and result: "f32", or "fp8"
    (e4m3 with a per-tensor amax scale, the gradient passed straight
    through)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return t
        scale = FP8_MAX / t.detach().abs().amax().clamp_min(1e-30)
        q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
        return t + (q - t.detach())


F32 = Precision("f32")


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return F.relu(x)
    if act == "leaky_relu":
        return F.leaky_relu(x, LEAKY_SLOPE)
    if act == "identity":
        return x
    raise ValueError(act)


class ReflectConv(nn.Module):
    """conv(reflect_pad(x, pad), w, stride) + b."""

    def __init__(self, cin, cout, k, stride=1, pad=None, prec=F32):
        super().__init__()
        self.stride, self.pad, self.prec = stride, k // 2 if pad is None else pad, prec
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        if self.pad:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        return self.prec.operand(F.conv2d(
            self.prec.operand(x), self.prec.operand(self.weight), self.bias,
            self.stride))


class CaSb(nn.Module):
    """conv -> [InstanceNorm] -> activation."""

    def __init__(self, cin, cout, k, stride=1, pad=None, act="relu",
                 norm=True, prec=F32):
        super().__init__()
        self.conv = ReflectConv(cin, cout, k, stride, pad, prec)
        self.act, self.norm = act, norm

    def forward(self, x):
        x = self.conv(x)
        if self.norm:
            x = F.instance_norm(x, eps=IN_EPS)
        if not self.norm and self.act == "identity":
            return x
        return self.conv.prec.operand(_act(x, self.act))


class DBlock(nn.Module):
    """pixel_unshuffle(2) -> conv3 -> ReLU -> IN."""

    def __init__(self, cin, cout, prec=F32):
        super().__init__()
        self.conv = ReflectConv(cin * 4, cout, 3, prec=prec)

    def forward(self, x):
        x = self.conv(F.pixel_unshuffle(x, 2))
        return self.conv.prec.operand(F.instance_norm(F.relu(x), eps=IN_EPS))


class UBlock(nn.Module):
    """pixel_shuffle(2) -> conv3 -> ReLU -> IN."""

    def __init__(self, cin, cout, prec=F32):
        super().__init__()
        self.conv = ReflectConv(cin // 4, cout, 3, prec=prec)

    def forward(self, x):
        x = self.conv(F.pixel_shuffle(x, 2))
        return self.conv.prec.operand(F.instance_norm(F.relu(x), eps=IN_EPS))


class RBlock(nn.Module):
    """IN(conv2(IN(ReLU(conv1(x))))) + x."""

    def __init__(self, c, prec=F32):
        super().__init__()
        self.conv1 = ReflectConv(c, c, 3, prec=prec)
        self.conv2 = ReflectConv(c, c, 3, prec=prec)

    def forward(self, x):
        q = self.conv1.prec.operand
        h = q(F.instance_norm(F.relu(self.conv1(x)), eps=IN_EPS))
        return q(q(F.instance_norm(self.conv2(h), eps=IN_EPS)) + x)


class SConv(nn.Module):
    def __init__(self, cin, cout, prec=F32):
        super().__init__()
        self.conv = ReflectConv(cin, cout, 3, prec=prec)

    def forward(self, x):
        return self.conv(x)


class Encoder(nn.Module):
    def __init__(self, w, prec=F32):
        super().__init__()
        self.model = nn.Sequential(
            CaSb(3, w, 7, prec=prec), DBlock(w, 2 * w, prec),
            DBlock(2 * w, 4 * w, prec), DBlock(4 * w, 8 * w, prec),
            DBlock(8 * w, 16 * w, prec), RBlock(16 * w, prec))

    def forward(self, x):
        return self.model(x)


class Decoder(nn.Module):
    def __init__(self, w, prec=F32):
        super().__init__()
        self.model = nn.Sequential(
            RBlock(16 * w, prec), UBlock(16 * w, 8 * w, prec),
            UBlock(8 * w, 4 * w, prec), UBlock(4 * w, 2 * w, prec),
            UBlock(2 * w, w, prec),
            CaSb(w, 3, 7, act="identity", norm=False, prec=prec))

    def forward(self, x):
        return self.model(x)


class VariationalEncoderBlock(nn.Module):
    """mu = L(x); logvar = clamp(S(S(x)), -10, 10); z = mu + eps *
    exp(logvar / 2), eps ~ N(0, 1) of mu's shape."""

    def __init__(self, c, latent, prec=F32):
        super().__init__()
        self.muConv = SConv(c, latent, prec)
        self.logvarConv = nn.Sequential(SConv(c, latent, prec),
                                        SConv(latent, latent, prec))

    def forward(self, x, generator: Optional[torch.Generator]):
        mu = self.muConv(x)
        logvar = self.logvarConv(x).clamp(-10.0, 10.0)
        std = torch.exp(0.5 * logvar)
        eps = torch.randn(std.shape, generator=generator, device=std.device,
                          dtype=torch.float32)
        return self.muConv.conv.prec.operand(mu + eps * std), mu, logvar


class VariationalDecoderBlock(nn.Module):
    def __init__(self, latent, c, prec=F32):
        super().__init__()
        self.conv = SConv(latent, c, prec)

    def forward(self, z):
        return self.conv(z)


class VAE(nn.Module):
    """Encoder -> variational block -> Decoder; (Gx, mu, logvar)."""

    def __init__(self, w, latent, prec=F32):
        super().__init__()
        self.encoder = Encoder(w, prec)
        self.variational_encoder_block = VariationalEncoderBlock(16 * w, latent,
                                                                 prec)
        self.variational_decoder_block = VariationalDecoderBlock(latent, 16 * w,
                                                                 prec)
        self.decoder = Decoder(w, prec)

    def forward(self, x, generator=None):
        z, mu, logvar = self.variational_encoder_block(self.encoder(x),
                                                       generator)
        return self.decoder(self.variational_decoder_block(z)), mu, logvar


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.linalg.vector_norm(t) + 1e-12)


class SpectralConv(nn.Module):
    """VALID conv with W / sigma(W): a training call runs one power
    iteration (v = unit(W^T u), u = unit(W v), no gradient) and keeps the new
    (u, v); sigma = u . W v."""

    def __init__(self, cin, cout, k, prec=F32):
        super().__init__()
        self.prec = prec
        self.bias = nn.Parameter(torch.empty(cout))
        self.weight_orig = nn.Parameter(torch.empty(cout, cin, k, k))
        self.register_buffer("weight_u", torch.empty(cout))
        self.register_buffer("weight_v", torch.empty(cin * k * k))

    def forward(self, x, update: bool):
        w = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if update:
            with torch.no_grad():
                v = _unit(w.t() @ u)
                u = _unit(w @ v)
            self.weight_u, self.weight_v = u, v
        sigma = u @ (w @ v)
        return self.prec.operand(F.conv2d(
            self.prec.operand(x), self.prec.operand(self.weight_orig / sigma),
            self.bias))


class Discriminator(nn.Module):
    """4 x (conv k4 s2 reflect 1, [IN], LeakyReLU 0.2), the first without
    IN, then the spectral conv over the whole 16x16 map: (B,) scores."""

    def __init__(self, w, final_kernel, prec=F32):
        super().__init__()
        kw = dict(k=4, stride=2, pad=1, act="leaky_relu", prec=prec)
        self.model = nn.Sequential(
            CaSb(3, w, norm=False, **kw), CaSb(w, 2 * w, **kw),
            CaSb(2 * w, 4 * w, **kw), CaSb(4 * w, 8 * w, **kw),
            SpectralConv(8 * w, 1, final_kernel, prec))

    def forward(self, x, update: bool = True):
        for block in self.model[:4]:
            x = block(x)
        return self.model[4](x, update).reshape(x.shape[0])

    def spectral_state(self):
        return self.model[4].weight_u, self.model[4].weight_v

    def set_spectral_state(self, state):
        self.model[4].weight_u, self.model[4].weight_v = state
