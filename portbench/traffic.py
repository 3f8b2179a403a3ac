"""The frames a cell's data tree is made of, from the run's seed: smooth
colour fields (a coarse random grid upsampled bicubically) with a fine
texture on top, drawn on the run's device in chunks and encoded by Pillow
in a thread pool. Each dataset (``datasets/<dataset>.py``) lays them out in
its published folder format under the run's data directory (inside
``TMPDIR``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

import torch
import torch.nn.functional as F

ENCODE_THREADS = 8
CHUNK = 128


def frames(n: int, h: int, w: int, seed: int, device):
    """Yields uint8 (k, h, w, 3) chunks of `n` seeded frames."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for lo in range(0, n, CHUNK):
        k = min(CHUNK, n - lo)
        coarse = torch.rand((k, 3, 6, 8), generator=gen, device=device)
        img = F.interpolate(coarse, size=(h, w), mode="bicubic",
                            align_corners=False)
        img = img + 0.06 * torch.rand((k, 3, h, w), generator=gen,
                                      device=device)
        yield (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).permute(
            0, 2, 3, 1).cpu().numpy()


def write(paths: List[Path], chunks, **save_kw) -> None:
    from PIL import Image

    def save(item):
        path, arr = item
        Image.fromarray(arr).save(path, **save_kw)

    with ThreadPoolExecutor(ENCODE_THREADS) as pool:
        at = 0
        for chunk in chunks:
            items = list(zip(paths[at:at + len(chunk)], chunk))
            list(pool.map(save, items))
            at += len(chunk)
