"""The published CycleGAN's history of generated images (``util/image_pool.py``
of ``junyanz/pytorch-CycleGAN-and-pix2pix``), which hands its
discriminators a mix of the newest fakes and older ones.

Per image of a query, in batch order: while the pool holds fewer than
`size` images, the image is stored and returned; otherwise ``p =
torch.rand(1)`` is drawn and, if p > 0.5, ``j = torch.randint(0, size,
(1,))``: slot j's image is returned and the new one stored there; else the
new image is returned. The draws come from a CPU ``torch.Generator`` (the
published code draws Python's ``random``), so the decisions are made on the
host and a query adds no wait for the device. The host works the batch
through in order, a slot that an earlier image of the same batch wrote
being read as that image; the device then makes two gathers over
``cat(pool, fresh)``: what the discriminator sees and the new pool.

The pool is a device tensor (size, C, H, W) in the fakes' dtype. As
published, it is not part of a checkpoint. While a profiler records, a
query is the span ``vct.pool`` (key: the pool's name) and every image it
returns counts one ``image_pool.history`` or ``image_pool.fresh``
(``utils.spans``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from vae_cyclegan_tpu_torch.utils import spans


def plan(count: int, size: int, n: int,
         stream: torch.Generator) -> Tuple[List[int], List[int], int, int]:
    """The decisions of a query of `n` images on a pool holding `count` of
    `size` images, drawn from `stream`: (per image returned, its index into
    cat(pool, fresh); per slot of the new pool, its index there; the new
    count; how many images came from the history)."""
    slots = list(range(size))
    out = []
    history = 0
    for i in range(n):
        src = size + i
        if count < size:
            slots[count] = src
            count += 1
            out.append(src)
        elif float(torch.rand(1, generator=stream)) > 0.5:
            j = int(torch.randint(0, size, (1,), generator=stream))
            out.append(slots[j])
            slots[j] = src
            history += 1
        else:
            out.append(src)
    return out, slots, count, history


class ImagePool:
    """A pool of `size` images of `shape` (C, H, W) in `dtype` on
    `device`."""

    def __init__(self, name: str, size: int, shape, dtype: torch.dtype,
                 device):
        self.name, self.size = name, size
        self.images = torch.zeros((size, *shape), dtype=dtype, device=device)
        self.count = 0

    def query(self, fresh: torch.Tensor,
              stream: Optional[torch.Generator]) -> torch.Tensor:
        """The images the discriminator sees for the detached batch
        `fresh` (NCHW, the pool's dtype); the pool updated. Without a
        stream the fresh images pass through and the pool stays as it
        is."""
        if stream is None:
            return fresh
        with spans.span("vct.pool", self.name):
            n = fresh.shape[0]
            out, slots, self.count, history = plan(self.count, self.size,
                                                   n, stream)
            idx = torch.tensor(out + slots, dtype=torch.int64)
            if fresh.device.type == "cuda":
                idx = idx.pin_memory().to(fresh.device, non_blocking=True)
            both = torch.cat([self.images, fresh.to(self.images.dtype)])
            seen = both.index_select(0, idx[:n])
            self.images = both.index_select(0, idx[n:])
            for _ in range(history):
                spans.count("image_pool.history")
            for _ in range(n - history):
                spans.count("image_pool.fresh")
            return seen
