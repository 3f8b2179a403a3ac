"""Summer2Winter (CycleGAN's unpaired ``trainA`` / ``trainB``) on the host
pipeline: per sample x = A[index mod |A|] and y = B[a drawn index], each
flipped, cropped, resized and colour-jittered with its own draws from the
sample's stream, in that order (``Summer2WinterDataset.get``)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.data import pil_augment


def batch(files, picks, p: dict, cfg: dict, device):
    files_a, files_b = files
    xs, ys = [], []
    for index, rng in picks:
        idx_b = rng.randint(0, len(files_b) - 1)
        xs.append(pil_augment(files_a[index % len(files_a)], rng,
                              cfg["image_size"], p["hflip_p"], p["jitter"]))
        ys.append(pil_augment(files_b[idx_b], rng, cfg["image_size"],
                              p["hflip_p"], p["jitter"]))
    return tuple(torch.from_numpy(np.stack(a)).to(device).permute(
        0, 3, 1, 2).float() / 255.0 for a in (xs, ys))
