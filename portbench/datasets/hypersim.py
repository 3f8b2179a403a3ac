"""Hypersim, paired, in its folder format
(``hypersim/ai_000_000_portbench/cam_00/frame_NNNN_<modality>.png``,
``frames`` pairs of ``frame_hw``), read by the program's
``HypersimDataset``: from its decode cache where ``decode_cache``, as raw
frames cropped, flipped and resized on the card where ``device_aug``. A
long epoch over the few frames on disk (``epoch_samples`` entries, entry i
is frame i mod ``frames``), so no epoch ends in a window, as none ends in
one of Hypersim's."""

from __future__ import annotations

from pathlib import Path

from portbench import traffic


class Repeat:
    """A dataset of `length` entries cycling over a few distinct frames."""

    def __init__(self, base, length: int):
        self.base, self.length = base, length

    def __len__(self):
        return self.length

    def get(self, idx, rng):
        return self.base.get(idx % len(self.base), rng)


def make(root: Path, p: dict, cfg: dict, seed: int, device):
    from vae_cyclegan_tpu_torch.data import (
        AugmentConfig, DecodedImageCache, HypersimDataset)

    d = root / "hypersim" / "ai_000_000_portbench" / "cam_00"
    d.mkdir(parents=True)
    h, w = p["frame_hw"]
    pairs = [tuple(d / f"frame_{i:04d}_{m}.png" for m in p["modalities"])
             for i in range(p["frames"])]
    for k in range(2):
        traffic.write([pair[k] for pair in pairs],
                      traffic.frames(len(pairs), h, w, seed * 2 + k, device),
                      compress_level=1)
    if p["decode_cache"]:
        DecodedImageCache(DecodedImageCache.build(
            root / "hypersim", root / "decoded.bin")).attach()
    base = HypersimDataset(
        str(root / "hypersim"), list(p["modalities"]),
        augment=AugmentConfig(out_size=cfg["image_size"],
                              hflip_p=p["hflip_p"], vflip_p=p["vflip_p"]),
        color_jitter=None, paired_mode=True, uint8_output=True,
        raw_mode=p["device_aug"])
    return Repeat(base, p["epoch_samples"]), tuple(pairs)
