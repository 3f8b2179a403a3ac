"""Reflection padding for NCHW tensors (every conv of the reference pads
with ``mode='reflect'``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the two spatial dims of an NCHW tensor by `pad` pixels."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")
