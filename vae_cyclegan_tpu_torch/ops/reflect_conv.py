"""Reflect-padded convolution: the materialized reflect pad + ``F.conv2d``.

This is the plain lowering for every conv the starved-conv dispatcher does
not claim (the JAX package leaves the same convs to XLA), and the plain
version the starved-conv kernel is checked against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vae_cyclegan_tpu_torch.ops.padding import reflect_pad


def reflect_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv(reflect_pad(x, k//2), w): NCHW x, OIHW w with odd k, stride 1,
    'same' output size, no bias."""
    return F.conv2d(reflect_pad(x, w.shape[-1] // 2), w)
