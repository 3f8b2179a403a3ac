"""Dataset classes consuming the reference's on-disk formats
(Data_Manager.py:18-451).

All __getitem__ implementations take an explicit `random.Random` so every
random decision (augmentation params, unpaired partner sampling) is owned by
the loader — reproducible and safe under worker parallelism.

Synchronization semantics preserved per dataset (Data_Manager.py):
  * Hypersim paired: x and y get IDENTICAL spatial params (:170-188)
  * Hypersim unpaired: y drawn from a random index with an INDEPENDENT
    param draw (:232-251)
  * Maps: two halves of one file share params (:377-381)
  * Summer2Winter: x and y independent draws (:444-449), y random index

Counterpart of ``vae_cyclegan_tpu/data/datasets.py``, the same code with
Pillow imported where it is used: the array paths (decode cache, native
decode and resize, raw mode) need no Pillow.
"""

from __future__ import annotations

import os
import random
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence

import numpy as np

from vae_cyclegan_tpu_torch.data.transforms import (
    AugmentConfig,
    ColorJitterConfig,
    apply_color_jitter,
    apply_spatial_np,
    apply_spatial_pil,
    finalize,
    finalize_np,
    sample_color_params,
    sample_spatial_params,
)

if TYPE_CHECKING:  # Pillow is imported where it is used
    from PIL import Image

Array = np.ndarray
_IMG_EXTS = (".jpg", ".jpeg", ".png")


class _Dataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def get(self, idx: int, rng: random.Random) -> Dict[str, Array]:
        raise NotImplementedError


class Subset(_Dataset):
    def __init__(self, base: _Dataset, indices: Sequence[int]):
        self.base = base
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def get(self, idx: int, rng: random.Random) -> Dict[str, Array]:
        return self.base.get(self.indices[idx], rng)


def split_dataset(dataset: _Dataset, test_split: float, seed: int = 42):
    """Random train/test split.

    The reference's train-side split is unseeded (train.py:212) while its
    test.py seeds 42 (test.py:195) — an inconsistency SURVEY.md §2.5 flags;
    here both sides use the same seeded split (seed 42 by default).
    """
    n = len(dataset)
    n_train = int((1 - test_split) * n)
    perm = list(range(n))
    random.Random(seed).shuffle(perm)
    return Subset(dataset, perm[:n_train]), Subset(dataset, perm[n_train:])


# optional decoded-image cache (data.cache.DecodedImageCache.attach())
_DECODE_CACHE = None


def set_decode_cache(cache) -> None:
    global _DECODE_CACHE
    _DECODE_CACHE = cache


def _load_rgb(path) -> Image.Image:
    from PIL import Image

    if _DECODE_CACHE is not None:
        arr = _DECODE_CACHE.get(path)
        if arr is not None:
            return Image.fromarray(arr)
    from vae_cyclegan_tpu_torch.data import native

    arr = native.decode_rgb(path)  # C++ libpng/libjpeg path (GIL-free)
    if arr is not None:
        return Image.fromarray(arr)
    with Image.open(path) as im:
        return im.convert("RGB")


class HypersimDataset(_Dataset):
    """Hypersim tree: root/sceneName/cam_XX/frame_NNNN_{modality}.png
    (Data_Manager.py:18-137).

    paired_mode: 1 modality -> x == y (autoencoder mode); 2 modalities ->
    x = modalities[0], y = modalities[1]. Unpaired: y from a random index.
    The 'color' modality gets ColorJitter before the spatial transform.
    """

    def __init__(
        self,
        root_dir: str,
        modalities: List[str],
        augment: Optional[AugmentConfig] = None,
        color_jitter: Optional[ColorJitterConfig] = None,
        paired_mode: bool = True,
        uint8_output: bool = False,
        raw_mode: bool = False,
    ):
        """raw_mode: emit full uint8 frames + augmentation parameter
        vectors ({x,y}_raw / {x,y}_aug) for ON-DEVICE augmentation
        (data.device_aug) — the host only decodes. Requires uniform frame
        sizes and no color jitter (jitter is a host-side PIL op)."""
        self.root_dir = Path(root_dir)
        self.modalities = list(modalities)
        self.augment = augment
        self.color_jitter = color_jitter
        self.paired_mode = paired_mode
        self.uint8_output = uint8_output
        self.raw_mode = raw_mode
        if raw_mode and color_jitter is not None:
            raise ValueError(
                "raw_mode (on-device augmentation) does not support host "
                "color jitter; drop color_jitter or raw_mode"
            )
        if self.paired_mode and len(self.modalities) not in (1, 2):
            raise ValueError(
                f"paired_mode requires 1 or 2 modalities, got {len(self.modalities)}"
            )
        if not self.paired_mode and len(self.modalities) != 2:
            raise ValueError("Unpaired mode requires exactly 2 modalities")
        self.samples = self._scan()
        if not self.samples:
            raise ValueError(f"No samples found in {root_dir}")

    def _scan(self) -> List[Dict]:
        samples = []
        for scene_dir in sorted(self.root_dir.iterdir()):
            if not scene_dir.is_dir():
                continue
            parts = scene_dir.name.split("_")
            if len(parts) >= 4:
                scene_num = "_".join(parts[:3])
                scene_type = "_".join(parts[3:])
            else:
                scene_num, scene_type = scene_dir.name, "unknown"
            for cam_dir in sorted(scene_dir.glob("cam_*")):
                if not cam_dir.is_dir():
                    continue
                first = self.modalities[0]
                for frame_file in sorted(cam_dir.glob(f"frame_*_{first}.png")):
                    frame_id = frame_file.stem.split("_")[1]
                    paths = {}
                    ok = True
                    for m in self.modalities:
                        p = cam_dir / f"frame_{frame_id}_{m}.png"
                        if p.exists():
                            paths[m] = p
                        else:
                            ok = False
                            break
                    if ok:
                        samples.append(
                            dict(
                                scene_num=scene_num,
                                scene_type=scene_type,
                                cam_num=cam_dir.name.replace("cam_", ""),
                                frame_id=frame_id,
                                modality_paths=paths,
                            )
                        )
        return samples

    def __len__(self) -> int:
        return len(self.samples)

    def _load_one(
        self, idx: int, modality: str, rng: random.Random, spatial_params
    ) -> Array:
        info = self.samples[idx]
        path = info["modality_paths"][modality]
        needs_jitter = modality == "color" and self.color_jitter is not None
        if not needs_jitter and self.augment is not None:
            # array fast path: cache slice / C++ decode -> C++ crop+resize,
            # skipping the PIL round-trip entirely (<=1 LSB vs PIL)
            arr = _DECODE_CACHE.get(path) if _DECODE_CACHE is not None else None
            if arr is None:
                from vae_cyclegan_tpu_torch.data import native

                arr = native.decode_rgb(path)
            if arr is not None:
                out = apply_spatial_np(arr, self.augment, spatial_params)
                if out is not None:
                    return finalize_np(out, self.uint8_output)
        img = _load_rgb(path)
        # color-specific jitter BEFORE the spatial transform
        # (Data_Manager.py:176-182)
        if needs_jitter:
            img = apply_color_jitter(img, sample_color_params(rng, self.color_jitter))
        if self.augment is not None:
            img = apply_spatial_pil(img, self.augment, spatial_params)
        return finalize(img, self.uint8_output)

    def _raw_frame(self, idx: int, modality: str) -> Array:
        path = self.samples[idx]["modality_paths"][modality]
        if _DECODE_CACHE is not None:  # raw mode: skip the PIL round-trip
            arr = _DECODE_CACHE.get(path)
            if arr is not None:
                return arr
        return np.asarray(_load_rgb(path), np.uint8)

    def _get_raw(self, idx: int, rng: random.Random) -> Dict[str, Array]:
        """Raw wire format for on-device augmentation: full uint8 frames +
        (6,) aug vectors, same synchronization semantics as the host path
        (paired: shared vector; unpaired: independent draw + random y)."""
        from vae_cyclegan_tpu_torch.data.device_aug import sample_aug_vector

        cfg = self.augment or AugmentConfig(random_crop=False)
        x = self._raw_frame(idx, self.modalities[0])
        h, w = x.shape[:2]
        shared = sample_aug_vector(rng, cfg, w, h)
        if self.paired_mode:
            y = (
                x
                if len(self.modalities) == 1
                else self._raw_frame(idx, self.modalities[1])
            )
            return {"x_raw": x, "x_aug": shared,
                    "y_raw": y, "y_aug": shared.copy()}
        y_idx = rng.randint(0, len(self.samples) - 1)
        y = self._raw_frame(y_idx, self.modalities[1])
        y_aug = sample_aug_vector(rng, cfg, y.shape[1], y.shape[0])
        return {"x_raw": x, "x_aug": shared, "y_raw": y, "y_aug": y_aug}

    def get(self, idx: int, rng: random.Random) -> Dict[str, Array]:
        if self.raw_mode:
            return self._get_raw(idx, rng)
        shared = (
            sample_spatial_params(rng, self.augment)
            if self.augment is not None
            else None
        )
        if self.paired_mode:
            if len(self.modalities) == 1:
                x = self._load_one(idx, self.modalities[0], rng, shared)
                return {"x": x, "y": x}
            x = self._load_one(idx, self.modalities[0], rng, shared)
            y = self._load_one(idx, self.modalities[1], rng, shared)
            return {"x": x, "y": y}
        # unpaired: y from random index with its own independent draw
        x = self._load_one(idx, self.modalities[0], rng, shared)
        y_idx = rng.randint(0, len(self.samples) - 1)
        y_params = (
            sample_spatial_params(rng, self.augment)
            if self.augment is not None
            else None
        )
        y = self._load_one(y_idx, self.modalities[1], rng, y_params)
        return {"x": x, "y": y}

    # scene filtering helpers (Data_Manager.py:279-323)
    def get_unique_scenes(self) -> List[str]:
        return sorted({s["scene_num"] for s in self.samples})

    def get_unique_scene_types(self) -> List[str]:
        return sorted({s["scene_type"] for s in self.samples})

    def filter_by(self, pred: Callable[[Dict], bool]) -> "HypersimDataset":
        out = HypersimDataset.__new__(HypersimDataset)
        out.__dict__.update(self.__dict__)
        out.samples = [s for s in self.samples if pred(s)]
        return out

    def filter_by_scene(self, scene_nums: List[str]) -> "HypersimDataset":
        return self.filter_by(lambda s: s["scene_num"] in scene_nums)

    def filter_by_scene_type(self, scene_types: List[str]) -> "HypersimDataset":
        return self.filter_by(lambda s: s["scene_type"] in scene_types)


class SatelliteMapDataset(_Dataset):
    """pix2pix maps format: each image is satellite|map side by side;
    left half -> x, right half -> y, synchronized augmentation
    (Data_Manager.py:326-386)."""

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        augment: Optional[AugmentConfig] = None,
        uint8_output: bool = False,
    ):
        self.uint8_output = uint8_output
        self.image_dir = os.path.join(root_dir, split)
        if not os.path.isdir(self.image_dir):
            raise ValueError(f"Directory not found: {self.image_dir}")
        self.images = sorted(
            f for f in os.listdir(self.image_dir) if f.lower().endswith(_IMG_EXTS)
        )
        if not self.images:
            raise ValueError(f"No images found in {self.image_dir}")
        self.augment = augment

    def __len__(self) -> int:
        return len(self.images)

    def get(self, idx: int, rng: random.Random) -> Dict[str, Array]:
        img = _load_rgb(os.path.join(self.image_dir, self.images[idx]))
        w, h = img.size
        half = w // 2
        satellite = img.crop((0, 0, half, h))
        map_img = img.crop((half, 0, w, h))
        if self.augment is not None:
            params = sample_spatial_params(rng, self.augment)
            satellite = apply_spatial_pil(satellite, self.augment, params)
            map_img = apply_spatial_pil(map_img, self.augment, params)
        return {
            "x": finalize(satellite, self.uint8_output),
            "y": finalize(map_img, self.uint8_output),
        }


class Summer2WinterDataset(_Dataset):
    """CycleGAN folder format {split}A/{split}B; x = A[idx % lenA],
    y = random B image; independent transforms; len = max(lenA, lenB)
    (Data_Manager.py:389-451)."""

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        augment: Optional[AugmentConfig] = None,
        color_jitter: Optional[ColorJitterConfig] = None,
        uint8_output: bool = False,
    ):
        self.uint8_output = uint8_output
        self.dir_A = os.path.join(root_dir, f"{split}A")
        self.dir_B = os.path.join(root_dir, f"{split}B")
        for d in (self.dir_A, self.dir_B):
            if not os.path.isdir(d):
                raise ValueError(f"Directory not found: {d}")
        self.images_A = sorted(
            f for f in os.listdir(self.dir_A) if f.lower().endswith(_IMG_EXTS)
        )
        self.images_B = sorted(
            f for f in os.listdir(self.dir_B) if f.lower().endswith(_IMG_EXTS)
        )
        if not self.images_A:
            raise ValueError(f"No images found in {self.dir_A}")
        if not self.images_B:
            raise ValueError(f"No images found in {self.dir_B}")
        self.augment = augment
        self.color_jitter = color_jitter

    def __len__(self) -> int:
        return max(len(self.images_A), len(self.images_B))

    def _load(self, path: str, rng: random.Random) -> Array:
        img = _load_rgb(path)
        if self.augment is not None:
            # reference order (train.py:309-319): flip -> crop -> ColorJitter
            # (jitter is pointwise, so flip/jitter order is immaterial);
            # jittering the cropped 256^2 image is ~4x cheaper than full-res
            img = apply_spatial_pil(
                img, self.augment, sample_spatial_params(rng, self.augment)
            )
            if self.color_jitter is not None:
                img = apply_color_jitter(
                    img, sample_color_params(rng, self.color_jitter)
                )
        return finalize(img, self.uint8_output)

    def get(self, idx: int, rng: random.Random) -> Dict[str, Array]:
        path_a = os.path.join(self.dir_A, self.images_A[idx % len(self.images_A)])
        idx_b = rng.randint(0, len(self.images_B) - 1)
        path_b = os.path.join(self.dir_B, self.images_B[idx_b])
        return {"x": self._load(path_a, rng), "y": self._load(path_b, rng)}
