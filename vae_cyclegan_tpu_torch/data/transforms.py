"""Augmentations with explicitly sampled parameters.

The reference synchronizes random transforms across modalities by saving and
restoring torch's global RNG state around each `transform(img)` call
(reference: Data_Manager.py:170-188, 377-381). The replacement samples
transform *parameters* once per example from an explicit `random.Random`,
then applies the same parameters to every modality — no global-state
tricks, reproducible under any parallelism.

Transform semantics mirror the torchvision pipeline used by train.py:
  RandomHorizontalFlip(p) / RandomVerticalFlip(p)
  RandomResizedCrop(size, scale=(0.33,1.0), ratio=(1,1), bicubic)
    (train.py:184-191)
  ColorJitter(brightness, contrast, saturation, hue) applied before the
    spatial transform for the color modality (train.py:194-196,
    Data_Manager.py:176-182)
Images stay in [0,1]; Normalize is commented out in the reference
(train.py:190).

Counterpart of ``vae_cyclegan_tpu/data/transforms.py``, the same code with
Pillow imported inside the functions that use it, so the package imports on
a machine without Pillow; a path that needs it then raises ImportError.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # Pillow is imported where it is used
    from PIL import Image


@dataclasses.dataclass(frozen=True)
class ColorJitterConfig:
    brightness: float = 0.3
    contrast: float = 0.3
    saturation: float = 0.3
    hue: float = 0.15


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    out_size: int = 256
    hflip_p: float = 0.5
    vflip_p: float = 0.0
    crop_scale: Tuple[float, float] = (0.33, 1.0)
    random_crop: bool = True  # False => deterministic Resize (test transform)


@dataclasses.dataclass(frozen=True)
class SpatialParams:
    hflip: bool
    vflip: bool
    # crop as fractions of the source image (resolution-independent so the
    # same params apply to x and y even if sizes differ slightly)
    area_frac: float
    top_frac: float
    left_frac: float


@dataclasses.dataclass(frozen=True)
class ColorParams:
    order: Tuple[int, int, int, int]
    brightness: float
    contrast: float
    saturation: float
    hue: float


def sample_spatial_params(rng: random.Random, cfg: AugmentConfig) -> SpatialParams:
    return SpatialParams(
        hflip=rng.random() < cfg.hflip_p,
        vflip=rng.random() < cfg.vflip_p,
        area_frac=rng.uniform(*cfg.crop_scale),
        top_frac=rng.random(),
        left_frac=rng.random(),
    )


def sample_color_params(
    rng: random.Random, cfg: ColorJitterConfig
) -> ColorParams:
    order = list(range(4))
    rng.shuffle(order)
    return ColorParams(
        order=tuple(order),
        brightness=rng.uniform(max(0.0, 1 - cfg.brightness), 1 + cfg.brightness),
        contrast=rng.uniform(max(0.0, 1 - cfg.contrast), 1 + cfg.contrast),
        saturation=rng.uniform(max(0.0, 1 - cfg.saturation), 1 + cfg.saturation),
        hue=rng.uniform(-cfg.hue, cfg.hue),
    )


def apply_spatial_pil(
    img: Image.Image, cfg: AugmentConfig, params: Optional[SpatialParams]
) -> Image.Image:
    """Flip + square RandomResizedCrop(ratio=1) + bicubic resize, in PIL.

    With ratio fixed at (1,1) the torchvision sampler reduces to: side =
    floor(sqrt(area_frac * W * H)) clamped to the image, uniform top-left.
    """
    from PIL import Image

    s = cfg.out_size
    if params is None or not cfg.random_crop:
        out = img.resize((s, s), Image.BICUBIC)
        if params is not None:
            if params.hflip:
                out = out.transpose(Image.FLIP_LEFT_RIGHT)
            if params.vflip:
                out = out.transpose(Image.FLIP_TOP_BOTTOM)
        return out

    if params.hflip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if params.vflip:
        img = img.transpose(Image.FLIP_TOP_BOTTOM)
    w, h = img.size
    side = int(round(math.sqrt(params.area_frac * w * h)))
    side = max(1, min(side, w, h))
    top = int(params.top_frac * (h - side + 1))
    left = int(params.left_frac * (w - side + 1))
    img = img.crop((left, top, left + side, top + side))
    return img.resize((s, s), Image.BICUBIC)


def apply_spatial(
    img: Image.Image, cfg: AugmentConfig, params: Optional[SpatialParams]
) -> np.ndarray:
    """apply_spatial_pil + f32 [0,1] conversion (ToTensor equivalent)."""
    return _to_float(apply_spatial_pil(img, cfg, params))


def apply_spatial_np(
    arr: np.ndarray, cfg: AugmentConfig, params: Optional[SpatialParams]
) -> Optional[np.ndarray]:
    """Native (C++) equivalent of apply_spatial_pil on a (H, W, 3) uint8
    array — crop fused into the resize via the source stride, flips
    applied to the small output (the resample grid is symmetric, so
    cropping the mirrored box and flipping the result is exact). Pixel
    values match the PIL path within 1 LSB (float vs fixed-point
    accumulation). Returns None when the native library is unavailable,
    so callers fall back to PIL."""
    from vae_cyclegan_tpu_torch.data import native

    s = cfg.out_size
    h, w = arr.shape[:2]
    if params is None or not cfg.random_crop:
        out = native.resize_rgb8(arr, s, s)
        if out is None:
            return None
        if params is not None:
            if params.hflip:
                out = out[:, ::-1]
            if params.vflip:
                out = out[::-1]
        return np.ascontiguousarray(out)
    side = int(round(math.sqrt(params.area_frac * w * h)))
    side = max(1, min(side, w, h))
    top = int(params.top_frac * (h - side + 1))
    left = int(params.left_frac * (w - side + 1))
    if params.hflip:
        left = w - side - left
    if params.vflip:
        top = h - side - top
    out = native.resize_rgb8(arr, s, s, crop=(top, left, side))
    if out is None:
        return None
    if params.hflip:
        out = out[:, ::-1]
    if params.vflip:
        out = out[::-1]
    return np.ascontiguousarray(out)


def finalize_np(arr: np.ndarray, uint8_output: bool) -> np.ndarray:
    if uint8_output:
        return arr
    return arr.astype(np.float32) / 255.0


def finalize(img: Image.Image, uint8_output: bool) -> np.ndarray:
    """PIL -> array. uint8 keeps the wire format 4x smaller (host->device
    transfer); normalization to [0,1] then happens on the device
    (engine.Engine._prep)."""
    if uint8_output:
        return np.asarray(img, dtype=np.uint8)
    return _to_float(img)


def _to_float(img: Image.Image) -> np.ndarray:
    return np.asarray(img, dtype=np.float32) / 255.0


def apply_color_jitter(img: Image.Image, params: ColorParams) -> Image.Image:
    """ColorJitter via PIL ops, matching torchvision's PIL backend (which is
    what the reference pipeline ran): ImageEnhance for brightness/contrast/
    saturation, HSV-mode channel shift for hue. C-speed (~1ms at 256^2)."""
    from PIL import Image, ImageEnhance

    for op in params.order:
        if op == 0 and params.brightness != 1.0:
            img = ImageEnhance.Brightness(img).enhance(params.brightness)
        elif op == 1 and params.contrast != 1.0:
            img = ImageEnhance.Contrast(img).enhance(params.contrast)
        elif op == 2 and params.saturation != 1.0:
            img = ImageEnhance.Color(img).enhance(params.saturation)
        elif op == 3 and params.hue != 0.0:
            h, s, v = img.convert("HSV").split()
            h_arr = np.asarray(h, dtype=np.uint8)
            h_arr = (h_arr.astype(np.int16)
                     + int(params.hue * 255)) % 256
            h = Image.fromarray(h_arr.astype(np.uint8), "L")
            img = Image.merge("HSV", (h, s, v)).convert("RGB")
    return img
