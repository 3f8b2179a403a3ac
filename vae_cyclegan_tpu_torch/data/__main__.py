"""Data pipeline demo: save sample batch grids to input_examples/.

Mirrors the reference's `python Data_Manager.py` block
(Data_Manager.py:454-525): builds a paired depth->normal loader with the
training augmentations, prints shapes/ranges, and writes PNG grids.

Usage: python -m vae_cyclegan_tpu_torch.data [data_dir] [out_dir]

Counterpart of ``vae_cyclegan_tpu/data/__main__.py``, copied; Pillow is
imported where a grid is drawn.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from vae_cyclegan_tpu_torch.data import (
    AugmentConfig,
    ColorJitterConfig,
    DataLoader,
    HypersimDataset,
)


def _grid(batch_nhwc: np.ndarray, nrow: int = 2):
    from PIL import Image

    n, h, w, _ = batch_nhwc.shape
    ncol = (n + nrow - 1) // nrow
    canvas = np.zeros((nrow * h, ncol * w, 3), np.float32)
    for i in range(n):
        r, c = i % nrow, i // nrow
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = batch_nhwc[i]
    return Image.fromarray((np.clip(canvas, 0, 1) * 255 + 0.5).astype(np.uint8))


def main() -> int:
    data_dir = sys.argv[1] if len(sys.argv) > 1 else "dataset/hypersim"
    out_dir = Path(sys.argv[2] if len(sys.argv) > 2 else "input_examples")
    out_dir.mkdir(exist_ok=True)

    dataset = HypersimDataset(
        data_dir,
        ["depth", "normal"],
        augment=AugmentConfig(out_size=256, hflip_p=0.5, vflip_p=0.3),
        color_jitter=ColorJitterConfig(0.3, 0.3, 0.3, 0.15),
        paired_mode=True,
    )
    loader = DataLoader(dataset, batch_size=4, shuffle=True, seed=0)
    batch = next(iter(loader))

    print(f"X (input) shape:  {batch['x'].shape}")
    print(f"Y (target) shape: {batch['y'].shape}")
    print(f"X value range: [{batch['x'].min():.3f}, {batch['x'].max():.3f}]")
    print(f"Y value range: [{batch['y'].min():.3f}, {batch['y'].max():.3f}]")

    _grid(batch["x"][:1]).save(out_dir / "x_sample.png")
    _grid(batch["y"][:1]).save(out_dir / "y_sample.png")
    _grid(batch["x"]).save(out_dir / "x_batch_grid.png")
    _grid(batch["y"]).save(out_dir / "y_batch_grid.png")
    _grid(np.concatenate([batch["x"], batch["y"]], axis=2)).save(
        out_dir / "xy_comparison.png"
    )
    print(f"Saved PNG grids to '{out_dir}/'")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
