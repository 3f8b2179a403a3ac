"""On-device augmentation: the host decodes, the card crops/flips/resizes.

The reference pipeline does decode + RandomResizedCrop + flips (+ jitter) on
host CPU workers (reference train.py:184-196, Data_Manager.py:170-188). Here
the host only decodes (or mmaps a decoded cache) and samples the
augmentation PARAMETERS; full frames ship as uint8 and the card applies the
synchronized spatial transform: bicubic (Keys, a = -0.5), anti-aliased.

Wire format per example (uniform raw size (H0, W0) per dataset):
    x_raw: (H0, W0, 3) uint8          y_raw: (H0, W0, 3) uint8
    x_aug: (6,) float32               y_aug: (6,) float32
        [hflip, vflip, top, left, side_h, side_w]  (crop box in raw pixels;
        side_h != side_w only on the deterministic eval path, which
        resizes the full — possibly non-square — frame like the host)

Counterpart of ``vae_cyclegan_tpu/data/device_aug.py``. ``crop_box`` and
``sample_aug_vector`` are its numpy code, copied. ``device_augment``
computes what its ``jax.image.scale_and_translate(method="cubic",
antialias=True)`` computes: per sample and axis a weight matrix built as
JAX's ``compute_weight_mat`` builds it (the kernel widened by 1/scale when
downsampling, each output column normalised to sum 1, zeroed where its
sample lies outside [-0.5, in - 0.5]), the flips folded in by reversing the
matrix's input axis, then two batched f32 products, H then W. JAX computes
this with an einsum outside any Pallas kernel; here it is the same einsum
in PyTorch. ``F.interpolate(mode="bicubic")`` is not it: it uses a = -0.75
without antialias and takes no crop box per sample.
"""

from __future__ import annotations

import contextlib
import math
import random
from typing import Iterator, Tuple

import numpy as np
import torch

from vae_cyclegan_tpu_torch.data.transforms import (
    AugmentConfig,
    SpatialParams,
    sample_spatial_params,
)

#: JAX's threshold below which a weight column's sum counts as zero
_MIN_SUM = 1000.0 * float(np.finfo(np.float32).eps)


def crop_box(
    params: SpatialParams, w: int, h: int, cfg: AugmentConfig
) -> Tuple[int, int, int]:
    """(top, left, side) of the square crop — the same arithmetic as the
    host path (transforms.apply_spatial_pil)."""
    if not cfg.random_crop:
        return 0, 0, min(w, h)  # deterministic eval path: full-frame resize
    side = int(round(math.sqrt(params.area_frac * w * h)))
    side = max(1, min(side, w, h))
    top = int(params.top_frac * (h - side + 1))
    left = int(params.left_frac * (w - side + 1))
    return top, left, side


def sample_aug_vector(
    rng: random.Random, cfg: AugmentConfig, w: int, h: int
) -> np.ndarray:
    """One (6,) float32 aug vector: [hflip, vflip, top, left,
    side_h, side_w]."""
    p = sample_spatial_params(rng, cfg)
    if not cfg.random_crop:
        # deterministic path: resize the FULL frame (aspect-squashing, like
        # the host's plain Resize), flips still honored
        return np.array(
            [float(p.hflip), float(p.vflip), 0.0, 0.0, float(h), float(w)],
            np.float32,
        )
    top, left, side = crop_box(p, w, h, cfg)
    return np.array(
        [float(p.hflip), float(p.vflip), float(top), float(left),
         float(side), float(side)],
        np.float32,
    )


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 at distances x >= 0 (JAX's
    ``_fill_keys_cubic_kernel``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def weight_matrices(in_size: int, out_size: int, start: torch.Tensor,
                    side: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """(B, in_size, out_size) f32 resampling weights of one axis: output
    pixel o reads the crop [start, start + side) of a (flipped where
    ``flip`` > 0.5) input axis, in f32 operations in JAX's order (scale =
    out / side, translation = -start * scale)."""
    f32 = dict(dtype=torch.float32, device=start.device)
    scale = out_size / side
    translation = -start * scale
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, **f32) + 0.5) * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)      # (B, out)
    dist = (torch.abs(sample_f[:, None, :]
                      - torch.arange(in_size, **f32)[None, :, None])
            / kernel_scale[:, None, None])                        # (B, in, out)
    w = _keys_cubic(dist)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > _MIN_SUM,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[:, None, :], w, torch.zeros_like(w))
    # a flipped input read at i is the input at in - 1 - i
    return torch.where(flip[:, None, None] > 0.5, w.flip(1), w)


@contextlib.contextmanager
def _ieee_f32() -> Iterator[None]:
    """f32 products in full f32 (no TF32) on the card, as JAX's einsum at
    HIGHEST precision computes them."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def device_augment(raw: torch.Tensor, aug: torch.Tensor,
                   out_size: int) -> torch.Tensor:
    """uint8 (B, H0, W0, 3) frames + (B, 6) aug vectors -> f32 (B, S, S, 3)
    in [0, 1], on the frames' device: x / 255, the flips, the crop box
    resized to S x S (bicubic, anti-aliased), clipped to [0, 1]."""
    _, h0, w0, _ = raw.shape
    aug = aug.to(device=raw.device, dtype=torch.float32)
    x = raw.to(torch.float32) / 255.0
    wh = weight_matrices(h0, out_size, aug[:, 2], aug[:, 4], aug[:, 1])
    ww = weight_matrices(w0, out_size, aug[:, 3], aug[:, 5], aug[:, 0])
    with _ieee_f32():
        rows = torch.einsum("bhs,bhwc->bswc", wh, x)
        y = torch.einsum("bwt,bswc->bstc", ww, rows)
    return torch.clamp(y, 0.0, 1.0)


def augment_batch(batch: dict, out_size: int) -> dict:
    """Map a raw wire-format batch to the standard {'x','y'} batch; batches
    without raw keys pass through unchanged."""
    if "x_raw" not in batch:
        return batch
    out = {
        "x": device_augment(batch["x_raw"], batch["x_aug"], out_size),
        "y": device_augment(batch["y_raw"], batch["y_aug"], out_size),
    }
    out.update(
        {k: v for k, v in batch.items()
         if k not in ("x_raw", "y_raw", "x_aug", "y_aug")}
    )
    return out
