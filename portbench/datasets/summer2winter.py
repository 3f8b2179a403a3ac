"""Summer2Winter in CycleGAN's folder format
(``summer2winter/train{A,B}/NNNNN.jpg``, ``frames_a`` and ``frames_b``
JPEGs of ``frame_hw``), read by the program's ``Summer2WinterDataset`` with
the host flip, crop and resize and the driver's colour jitter, as
``train.py --dataset summer2winter`` builds it."""

from __future__ import annotations

from pathlib import Path

from portbench import traffic


def make(root: Path, p: dict, cfg: dict, seed: int, device):
    from vae_cyclegan_tpu_torch.data import (
        AugmentConfig, ColorJitterConfig, Summer2WinterDataset)

    files = []
    for k, side in enumerate(("A", "B")):
        d = root / "summer2winter" / f"train{side}"
        d.mkdir(parents=True)
        paths = [d / f"{i:05d}.jpg" for i in range(p[f"frames_{side.lower()}"])]
        h, w = p["frame_hw"]
        traffic.write(paths, traffic.frames(len(paths), h, w, seed * 2 + k,
                                            device), quality=90)
        files.append(paths)
    dataset = Summer2WinterDataset(
        str(root / "summer2winter"), "train",
        augment=AugmentConfig(out_size=cfg["image_size"],
                              hflip_p=p["hflip_p"]),
        color_jitter=ColorJitterConfig(*p["jitter"]), uint8_output=True)
    return dataset, tuple(files)
