"""TensorBoard logging + resume-time event truncation.

Tag schema is identical to the reference driver (train.py:528-563):
scalars `Loss/train`, `Loss_Components_train/{key}`, `Loss/test`,
`Loss_Components_test/{key}`; images `{src}/test_x`, `{tgt}/test_y`,
`{tgt}/test_Gx`, `{src}/test_Fy` (first 4 of batch, clamped to [0,1]).

`truncate_tensorboard_events` rewinds TB curves to a checkpoint epoch on
resume so curves don't fork (reference utils.py:242-302).

Counterpart of ``vae_cyclegan_tpu/utils/tb.py``, copied.
"""

from __future__ import annotations

import glob
import io
import os
from pathlib import Path

import numpy as np


class TBWriter:
    """Thin wrapper over torch's SummaryWriter (host-side logging)."""

    def __init__(self, log_dir):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=str(log_dir))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.writer.add_scalar(tag, float(value), step)

    def add_images(self, tag: str, images_nhwc: np.ndarray, step: int) -> None:
        """images: (N, H, W, C) float in [0,1] (NHWC is our native layout)."""
        arr = np.clip(np.asarray(images_nhwc), 0.0, 1.0)
        self.writer.add_images(tag, arr, step, dataformats="NHWC")

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()


def truncate_tensorboard_events(tensorboard_dir, max_epoch: int) -> None:
    """Keep only events with step <= max_epoch (utils.py:242-302)."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )
    from torch.utils.tensorboard import SummaryWriter
    from PIL import Image

    tensorboard_dir = Path(tensorboard_dir)
    event_files = sorted(glob.glob(str(tensorboard_dir / "events.out.tfevents.*")))
    if not event_files:
        print("No TensorBoard event files found, nothing to truncate")
        return

    ea = EventAccumulator(
        str(tensorboard_dir), size_guidance={"scalars": 0, "images": 0}
    )
    ea.Reload()

    scalars_to_keep = {
        tag: [(e.step, e.value) for e in ea.Scalars(tag) if e.step <= max_epoch]
        for tag in ea.Tags().get("scalars", [])
    }
    images_to_keep = {
        tag: [
            (e.step, e.encoded_image_string)
            for e in ea.Images(tag)
            if e.step <= max_epoch
        ]
        for tag in ea.Tags().get("images", [])
    }

    for event_file in event_files:
        os.remove(event_file)
        print(f"Removed old TensorBoard event file: {event_file}")

    writer = SummaryWriter(log_dir=str(tensorboard_dir))
    for tag, events in scalars_to_keep.items():
        for step, value in events:
            writer.add_scalar(tag, value, step)
    for tag, events in images_to_keep.items():
        for step, encoded in events:
            img = np.array(Image.open(io.BytesIO(encoded)))
            writer.add_image(tag, img, step, dataformats="HWC")
    writer.close()

    kept_s = sum(len(v) for v in scalars_to_keep.values())
    kept_i = sum(len(v) for v in images_to_keep.values())
    print(
        f"Truncated TensorBoard logs to epoch {max_epoch}: kept {kept_s} "
        f"scalar events and {kept_i} image events"
    )
