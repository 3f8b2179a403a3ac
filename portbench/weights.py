"""The weights of a run, made from its seed on the run's device.

One ``torch.randn`` call on a ``torch.Generator`` of the device draws every
conv weight and every power-iteration vector at once; the draw is then cut
into the leaves of the published ``state_dict`` (sorted by key) and scaled:
conv weights Kaiming-normal over fan_out (cout * k * k) with the ReLU gain,
or the LeakyReLU(0.2) gain for discriminators the configuration says keep
it (``d_init``), biases zero, ``weight_u`` / ``weight_v`` unit vectors. The
program and the reference are handed the same dict.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.steps import family


def shapes(cfg: dict) -> Dict[str, torch.Size]:
    """The published state_dict's keys and shapes for `cfg`."""
    fam = family(cfg, device="meta")
    return {k: v.shape for k, v in fam.nets.state_dict().items()}


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights for `cfg` from `seed`, on `device`."""
    leaves = sorted(shapes(cfg).items())
    drawn = [(k, s) for k, s in leaves
             if len(s) == 4 or k.endswith(("weight_u", "weight_v"))]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, s in leaves:
        if len(s) == 4:
            n = math.prod(s)
            disc = k.split(".")[0].startswith("D")
            gain2 = (2.0 / (1.0 + 0.2 ** 2)
                     if disc and cfg["d_init"] == "leaky_relu" else 2.0)
            std = math.sqrt(gain2 / (s[0] * s[2] * s[3]))
            out[k] = flat[at:at + n].view(s).mul_(std)
            at += n
        elif k.endswith(("weight_u", "weight_v")):
            n = math.prod(s)
            v = flat[at:at + n]
            out[k] = v / torch.linalg.vector_norm(v)
            at += n
        else:
            out[k] = torch.zeros(s, device=device)
    return out
