"""Atomic network blocks, NCHW ``nn.Module``s (counterparts of
``vae_cyclegan_tpu/models/blocks.py``):

  * CaSb: conv -> [InstanceNorm] -> activation
  * D:    pixel_unshuffle -> conv3 -> ReLU -> IN
  * R:    conv -> ReLU -> IN -> conv -> IN -> +residual
  * U:    pixel_shuffle -> conv3 -> ReLU -> IN
  * S/L:  bare 3x3 reflect-pad convs

Parameter names follow the reference's torch modules (``conv.weight``,
``conv1.bias``, ...), so its ``state_dict`` keys line up. Parameters are
held in float32; convs run in the block's ``dtype`` (the input's when None),
with the bias added after the conv in that dtype. ``instance_norm`` is the
configuration's InstanceNorm mode (``ops.instance_norm.instance_norm_act``),
threaded through the blocks as the JAX package threads ``use_pallas``.

Under spatial parallelism (``parallel.spatial``: a rank holds some rows of
each image) the convs take their halo rows from the neighbours
(``ReflectConv``: the stride-1 convs through ``starved_conv.
spatial_reflect_conv``, the strided ones through ``reflect_conv.
halo_conv``), and the D and U blocks' pixel (un)shuffle stays local: the D
blocks refuse an odd local height (``parallel.spatial.refuse``); a shuffle
doubles every local row and is always local.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vae_cyclegan_tpu_torch.ops import (
    instance_norm_act,
    kaiming_normal_fan_out,
    pixel_shuffle,
    pixel_unshuffle,
    reflect_conv,
    reflect_pad,
    starved_reflect_conv,
)
from vae_cyclegan_tpu_torch.ops.instance_norm import ACTS
from vae_cyclegan_tpu_torch.ops.reflect_conv import halo_conv
from vae_cyclegan_tpu_torch.ops.starved_conv import spatial_reflect_conv
from vae_cyclegan_tpu_torch.parallel import spatial

_TORCH_ACT_NAMES = {
    "ReLU": "relu",
    "LeakyReLU": "leaky_relu",
    "Tanh": "tanh",
    "Sigmoid": "sigmoid",
    "Identity": "identity",
}


def _act_name(activation: str) -> str:
    if activation in _TORCH_ACT_NAMES:
        return _TORCH_ACT_NAMES[activation]
    if activation in _TORCH_ACT_NAMES.values():
        return activation
    raise NotImplementedError(f"Activation not implemented: {activation}")


class ReflectConv(nn.Module):
    """Reflect-padded conv, the only conv primitive the reference uses.

    Stride-1 SAME convs go through the starved-conv dispatcher (kernel for
    the starved shapes, plain conv otherwise); other strides reflect-pad and
    run a VALID strided conv."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: Optional[torch.dtype] = None, device=None,
                 kernel_init_nonlinearity: str = "relu"):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.kernel_init_nonlinearity = kernel_init_nonlinearity
        self.weight = nn.Parameter(torch.empty(
            features, cin, kernel_size, kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-normal fan_out weight drawn from `generator` with the
        gain of `kernel_init_nonlinearity`, zero bias."""
        self.weight.copy_(kaiming_normal_fan_out(
            self.weight.shape, generator, self.kernel_init_nonlinearity))
        self.bias.zero_()

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        k = w.shape[-1]
        same = self.stride == 1 and self.padding == k // 2
        if spatial.current() is not None:
            site = f"the k{k} s{self.stride} conv {tuple(w.shape)}"
            if same:
                return spatial_reflect_conv(x, w, site)
            return halo_conv(x, w, self.stride, self.padding, site)
        if same:
            return starved_reflect_conv(x, w)
        return F.conv2d(reflect_pad(x, self.padding), w, stride=self.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        y = self._conv(x.to(dtype), self.weight.to(dtype))
        return y + self.bias.to(y.dtype)[:, None, None]


class PlainReflectConv(ReflectConv):
    """ReflectConv that always runs the plain conv. The D blocks use it:
    the JAX package computes their unshuffle + conv3 as one strided XLA
    conv (``ops/block_conv.py::down2_conv``), which never reaches the
    starved-conv kernel."""

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if spatial.current() is not None:
            return halo_conv(x, w, site=f"the D block conv {tuple(w.shape)}")
        return reflect_conv(x, w)


class CaSb(nn.Module):
    """Conv -> optional InstanceNorm -> activation."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 3, activation: str = "ReLU",
                 use_norm: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 kernel_init_nonlinearity: str = "relu",
                 instance_norm: str = "auto"):
        super().__init__()
        self.act = _act_name(activation)
        self.use_norm = use_norm
        self.instance_norm = instance_norm
        self.conv = ReflectConv(cin, features, kernel_size, stride, padding,
                                dtype=dtype, device=device,
                                kernel_init_nonlinearity=kernel_init_nonlinearity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.use_norm:
            return instance_norm_act(x, act=self.act, order="norm_act",
                                     mode=self.instance_norm)
        if self.act == "identity":
            return x
        return ACTS[self.act](x.float()).to(x.dtype)


class DBlock(nn.Module):
    """PixelUnshuffle(2) -> conv3x3(cin*4 -> features) -> ReLU -> IN."""

    def __init__(self, cin: int, features: int,
                 dtype: Optional[torch.dtype] = None, device=None,
                 instance_norm: str = "auto"):
        super().__init__()
        self.instance_norm = instance_norm
        self.conv = PlainReflectConv(cin * 4, features, 3, 1, 1, dtype=dtype,
                                     device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.current() is not None and x.shape[2] % 2:
            cout = self.conv.weight.shape[0]
            spatial.refuse(f"the D block {x.shape[1]}->{cout}'s pixel "
                           "unshuffle", x.shape[2],
                           "an even count to unshuffle locally")
        x = self.conv(pixel_unshuffle(x, 2))
        return instance_norm_act(x, act="relu", order="act_norm",
                                 mode=self.instance_norm)


class RBlock(nn.Module):
    """conv -> ReLU -> IN -> conv -> IN -> + residual (no activation after
    the add)."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 device=None, instance_norm: str = "auto"):
        super().__init__()
        self.instance_norm = instance_norm
        self.conv1 = ReflectConv(features, features, 3, 1, 1, dtype=dtype,
                                 device=device)
        self.conv2 = ReflectConv(features, features, 3, 1, 1, dtype=dtype,
                                 device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = instance_norm_act(self.conv1(x), act="relu", order="act_norm",
                              mode=self.instance_norm)
        h = instance_norm_act(self.conv2(h), act="identity", order="act_norm",
                              mode=self.instance_norm)
        return h + x


class UBlock(nn.Module):
    """PixelShuffle(2) -> conv3x3(cin/4 -> features) -> ReLU -> IN.

    ``forward``'s `instance_norm`, when given, overrides the block's mode for
    the call (the Decoder's U4 site, ``networks.Decoder``)."""

    def __init__(self, cin: int, features: int,
                 dtype: Optional[torch.dtype] = None, device=None,
                 instance_norm: str = "auto"):
        super().__init__()
        self.instance_norm = instance_norm
        self.conv = ReflectConv(cin // 4, features, 3, 1, 1, dtype=dtype,
                                device=device)

    def forward(self, x: torch.Tensor,
                instance_norm: Optional[str] = None) -> torch.Tensor:
        x = self.conv(pixel_shuffle(x, 2))
        return instance_norm_act(x, act="relu", order="act_norm",
                                 mode=instance_norm or self.instance_norm)


class SConv(nn.Module):
    """Bare 3x3 reflect-pad conv."""

    def __init__(self, cin: int, features: int,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.conv = ReflectConv(cin, features, 3, 1, 1, dtype=dtype,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class LConv(SConv):
    """Bare 3x3 reflect-pad conv, identical to SConv (the reference keeps
    both names)."""
