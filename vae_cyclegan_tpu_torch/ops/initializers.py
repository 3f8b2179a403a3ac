"""Kaiming (He) normal fan_out initialization matching the reference.

The reference initializes conv weights with ``kaiming_normal_(w,
mode='fan_out', nonlinearity='relu')`` and zero biases. Weights are OIHW,
so fan_out = cout * kh * kw. Draws come from an explicit ``torch.Generator``
on the CPU, so one seed gives the same weights whatever the target device.
"""

from __future__ import annotations

import math

import torch


def kaiming_normal_fan_out(shape, generator: torch.Generator) -> torch.Tensor:
    """float32 CPU tensor of `shape` (OIHW) drawn N(0, 2 / fan_out), the
    relu gain."""
    cout, _, kh, kw = shape
    std = math.sqrt(2.0 / (cout * kh * kw))
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32) * std
