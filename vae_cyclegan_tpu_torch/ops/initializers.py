"""Kaiming (He) normal fan_out initialization matching the reference.

The reference initializes conv weights with ``kaiming_normal_(w,
mode='fan_out', nonlinearity='relu')`` and zero biases; its Discriminator
uses ``nonlinearity='leaky_relu', a=0.2``. Weights are OIHW, so fan_out =
cout * kh * kw. Draws come from an explicit ``torch.Generator`` on the CPU,
so one seed gives the same weights whatever the target device.
"""

from __future__ import annotations

import math

import torch


def kaiming_normal_fan_out(shape, generator: torch.Generator,
                           nonlinearity: str = "relu",
                           a: float = 0.2) -> torch.Tensor:
    """float32 CPU tensor of `shape` (OIHW) drawn N(0, gain^2 / fan_out):
    gain sqrt(2) for relu, sqrt(2 / (1 + a^2)) for leaky_relu."""
    if nonlinearity == "relu":
        gain2 = 2.0
    elif nonlinearity == "leaky_relu":
        gain2 = 2.0 / (1.0 + a * a)
    else:
        raise NotImplementedError(f"nonlinearity {nonlinearity}")
    cout, _, kh, kw = shape
    std = math.sqrt(gain2 / (cout * kh * kw))
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32) * std
