"""Model FLOPs of a configuration, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the reference on ``meta``
tensors at the cell's shapes: the yardstick of ``mfu.*``, not the
program's own count. A training step is the forward and backward passes of
the generator and the discriminator updates (nothing recomputed, the
optimizer's elementwise work not counted); serving is one generator
forward."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.steps import family


def per_image(cfg: dict, kind: str, batch: int) -> float:
    fam = family(cfg, device="meta")
    s = cfg["image_size"]
    x = torch.empty(batch, 3, s, s, device="meta")
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            fam.model_flops_pass(x, torch.empty_like(x), None)
        else:
            with torch.no_grad():
                fam.generate(x, None)
    return counter.get_total_flops() / batch
