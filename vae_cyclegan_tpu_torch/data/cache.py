"""Memory-mapped decoded-image cache.

PNG/JPEG decode is the host's largest per-image cost; at a card's feed
rate the decoder becomes the wall. This cache decodes every image ONCE
into a flat uint8 blob (one .bin + one .json index) that training
processes mmap; a cache hit is an O(1) page-mapped slice copy instead of a
decode.

Build: ``DecodedImageCache.build(root, out_path)``.

Use: ``DecodedImageCache(path).attach()`` before constructing datasets;
every dataset decode goes through ``datasets._load_rgb`` and consults the
attached cache first. Images are keyed by absolute path; mixed sizes are
supported (per-image shape in the index).

Counterpart of ``vae_cyclegan_tpu/data/cache.py``, with the same ``.bin``
+ ``.json`` layout, so either package reads the other's cache.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np

_IMG_EXTS = (".jpg", ".jpeg", ".png")


class DecodedImageCache:
    def __init__(self, cache_path):
        self.cache_path = Path(cache_path)
        with open(self.cache_path.with_suffix(".json")) as f:
            meta = json.load(f)
        self.index: Dict[str, dict] = meta["index"]
        self.blob = np.memmap(self.cache_path, dtype=np.uint8, mode="r")

    def __contains__(self, path) -> bool:
        return str(Path(path).absolute()) in self.index

    def __len__(self) -> int:
        return len(self.index)

    def get(self, path) -> Optional[np.ndarray]:
        entry = self.index.get(str(Path(path).absolute()))
        if entry is None:
            return None
        off, shape = entry["offset"], tuple(entry["shape"])
        n = int(np.prod(shape))
        return np.asarray(self.blob[off : off + n]).reshape(shape)

    def attach(self) -> "DecodedImageCache":
        """Route all dataset decodes through this cache (misses fall back
        to PIL decode)."""
        from vae_cyclegan_tpu_torch.data import datasets

        datasets.set_decode_cache(self)
        return self

    @staticmethod
    def build(root, out_path, paths: Optional[Iterable] = None,
              chunk: int = 256) -> Path:
        """Decode every image under `root` (or the explicit `paths`) into
        `out_path` (+ .json index). Returns the blob path.

        Uses the C++ threaded decoder (data/native) in `chunk`-sized
        batches when available, falling back to PIL per image."""
        from vae_cyclegan_tpu_torch.data import native

        out_path = Path(out_path)
        if paths is None:
            paths = sorted(
                p for p in Path(root).rglob("*")
                if p.suffix.lower() in _IMG_EXTS
            )
        paths = list(paths)
        index: Dict[str, dict] = {}
        offset = 0
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "wb") as blob:
            for lo in range(0, len(paths), chunk):
                batch = paths[lo:lo + chunk]
                arrs = native.decode_many(batch) or [None] * len(batch)
                for p, arr in zip(batch, arrs):
                    if arr is None:
                        from PIL import Image

                        with Image.open(p) as im:
                            arr = np.asarray(im.convert("RGB"), np.uint8)
                    blob.write(arr.tobytes())
                    index[str(Path(p).absolute())] = {
                        "offset": offset,
                        "shape": list(arr.shape),
                    }
                    offset += arr.size
        with open(out_path.with_suffix(".json"), "w") as f:
            json.dump({"version": 1, "index": index}, f)
        return out_path
