"""What the reference's derivations of a dataset's augmented samples share
(``reference/datasets/<dataset>.py``), and the rule that hands each sample
its augmentation stream.

Every sample a benchmark run loads draws its flips, crop and jitter from
its own ``random.Random``, seeded from (the run's seed, the harness's count
of ``train_epoch`` calls, the sample's dataset index) by ``augment_rng``,
in place of the stream the program's loader would hand it. Both sides
follow that rule, so the reference needs nothing of how the loader orders
an epoch or seeds its workers. What a dataset draws from the stream
follows the published data pipeline (``train.py``: torchvision's
RandomHorizontalFlip / RandomVerticalFlip, RandomResizedCrop(scale (0.33,
1), ratio 1, bicubic) and ColorJitter on the PIL backend), drawn in the
order the dataset's ``get`` draws them. The on-card resize of the raw wire
is recomputed here as the anti-aliased Keys cubic (a = -0.5) resampling it
stands for, from its definition.
"""

from __future__ import annotations

import math
import random
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch


def augment_rng(seed: int, epoch: int, index: int) -> random.Random:
    """The augmentation stream of dataset entry `index` in the run's
    `epoch`-th ``train_epoch`` call."""
    return random.Random(((seed % 2 ** 61) * 1_000_003 + epoch) * 1_000_003
                         + index)


def spatial(rng: random.Random, hflip_p: float, vflip_p: float):
    return (rng.random() < hflip_p, rng.random() < vflip_p,
            rng.uniform(0.33, 1.0), rng.random(), rng.random())


def crop_box(area, top_f, left_f, w, h) -> Tuple[int, int, int]:
    side = max(1, min(int(round(math.sqrt(area * w * h))), w, h))
    return int(top_f * (h - side + 1)), int(left_f * (w - side + 1)), side


# -- the host pipeline (PIL) --------------------------------------------------


def pil_augment(path: Path, rng: random.Random, size: int, hflip_p: float,
                 jitter: Sequence[float]) -> np.ndarray:
    from PIL import Image, ImageEnhance

    img = Image.open(path).convert("RGB")
    hflip, vflip, area, top_f, left_f = spatial(rng, hflip_p, 0.0)
    if hflip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if vflip:
        img = img.transpose(Image.FLIP_TOP_BOTTOM)
    w, h = img.size
    top, left, side = crop_box(area, top_f, left_f, w, h)
    img = img.crop((left, top, left + side, top + side)).resize(
        (size, size), Image.BICUBIC)
    order = list(range(4))
    rng.shuffle(order)
    b, c, s = (rng.uniform(max(0.0, 1 - j), 1 + j) for j in jitter[:3])
    hue = rng.uniform(-jitter[3], jitter[3])
    for op in order:
        if op == 0 and b != 1.0:
            img = ImageEnhance.Brightness(img).enhance(b)
        elif op == 1 and c != 1.0:
            img = ImageEnhance.Contrast(img).enhance(c)
        elif op == 2 and s != 1.0:
            img = ImageEnhance.Color(img).enhance(s)
        elif op == 3 and hue != 0.0:
            hh, ss, vv = img.convert("HSV").split()
            shifted = (np.asarray(hh, np.int16) + int(hue * 255)) % 256
            hh = Image.fromarray(shifted.astype(np.uint8), "L")
            img = Image.merge("HSV", (hh, ss, vv)).convert("RGB")
    return np.asarray(img, np.uint8)


# -- the raw wire, resized on the card ----------------------------------------


def _keys(t: np.ndarray) -> np.ndarray:
    t = np.abs(t)
    near = (1.5 * t - 2.5) * t * t + 1.0
    far = ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0
    return np.where(t < 1.0, near, np.where(t < 2.0, far, 0.0))


def resample_matrix(n_in: int, n_out: int, start: int, side: int,
                    flip: bool) -> np.ndarray:
    """(n_out, n_in) weights of the anti-aliased cubic resize of the crop
    [start, start + side) of a (flipped) axis to n_out samples: output o
    sits at input coordinate start + (o + 0.5) side / n_out - 0.5, the
    kernel widens by side / n_out when shrinking, each row sums to 1, and a
    sample outside [-0.5, n_in - 0.5] is 0."""
    step = side / n_out
    widen = max(step, 1.0)
    c = start + (np.arange(n_out) + 0.5) * step - 0.5
    w = _keys((np.arange(n_in)[None, :] - c[:, None]) / widen)
    w = w / w.sum(axis=1, keepdims=True)
    w[(c < -0.5) | (c > n_in - 0.5)] = 0.0
    return np.ascontiguousarray(w[:, ::-1]) if flip else w


def resize_on(raw: np.ndarray, box, size: int, device) -> torch.Tensor:
    """One raw uint8 (H, W, 3) frame through the crop, flips and resize:
    (3, size, size) f32 in [0, 1] on `device`, full f32 products."""
    hflip, vflip, top, left, side = box
    h, w = raw.shape[:2]
    wh = torch.from_numpy(resample_matrix(h, size, top, side, vflip)).float()
    ww = torch.from_numpy(resample_matrix(w, size, left, side, hflip)).float()
    x = torch.from_numpy(np.array(raw)).to(device).permute(2, 0, 1).float() / 255.0
    out = wh.to(device) @ x @ ww.to(device).t()
    return out.clamp(0.0, 1.0)
