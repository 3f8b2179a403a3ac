"""PixelShuffle / PixelUnshuffle for NCHW tensors.

torch folds the sub-pixel positions as ``(c, s1, s2)``, the order the JAX
package reproduces in NHWC, so filter channels line up with no permutation.
The JAX package's optimization-barrier adjoints only steer XLA layouts on
the TPU and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_unshuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, C*f*f, H/f, W/f)."""
    return F.pixel_unshuffle(x, factor)


def pixel_shuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, C/(f*f), H*f, W*f)."""
    return F.pixel_shuffle(x, factor)
