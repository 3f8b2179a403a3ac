"""Hypersim, paired, on the raw wire: per sample the raw (x, y) frames of
entry index mod the frames on disk, one (hflip, vflip, crop) draw from the
sample's stream shared by both, then the crop, the flips and the
anti-aliased cubic resize the card does (``device_aug``), recomputed in
float32 from their definition."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from portbench.reference.data import crop_box, resize_on, spatial


@lru_cache(maxsize=1)
def _frames(files):
    from PIL import Image

    return [tuple(np.asarray(Image.open(f).convert("RGB"), np.uint8)
                  for f in pair) for pair in files]


def batch(files, picks, p: dict, cfg: dict, device):
    frames = _frames(tuple(tuple(pair) for pair in files))
    s = cfg["image_size"]
    xs, ys = [], []
    for index, rng in picks:
        hflip, vflip, area, top_f, left_f = spatial(rng, p["hflip_p"],
                                                    p["vflip_p"])
        x, y = frames[index % len(frames)]
        h, w = x.shape[:2]
        top, left, side = crop_box(area, top_f, left_f, w, h)
        box = (hflip, vflip, top, left, side)
        xs.append(resize_on(x, box, s, device))
        ys.append(resize_on(y, box, s, device))
    return torch.stack(xs), torch.stack(ys)
