"""Reflect-padded convolution: the materialized reflect pad + ``F.conv2d``.

This is the plain lowering for every conv the starved-conv dispatcher does
not claim (the JAX package leaves the same convs to XLA), and the plain
version the starved-conv kernel is checked against.

Under spatial parallelism (``parallel.spatial``) a rank holds some rows of
each image: ``halo_conv`` takes the halo rows from its neighbours (reflect
rows at the image's true borders), reflect-pads the width only and runs a
conv that is VALID in H, so each output row is the one-process conv's. It
serves every stride-1 'same' conv and the discriminator's k4 s2 pad-1
convs (halo 1 above and below; the output rows line up with the global
ones when the local height is even).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vae_cyclegan_tpu_torch.ops.padding import reflect_cols, reflect_pad


def reflect_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv(reflect_pad(x, k//2), w): NCHW x, OIHW w with odd k, stride 1,
    'same' output size, no bias."""
    return F.conv2d(reflect_pad(x, w.shape[-1] // 2), w)


def halo_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              pad: Optional[int] = None,
              site: str = "a conv") -> torch.Tensor:
    """This rank's output rows of conv(reflect_pad(x, pad), w, stride) over
    the whole (row-sharded) image: the halo rows (``parallel.spatial.
    halo``), the width reflect-padded, a conv VALID in H. `pad` defaults to
    k // 2 (stride 1, 'same'); at stride 2 the local height must be even."""
    from vae_cyclegan_tpu_torch.parallel import spatial

    k = w.shape[-1]
    pad = k // 2 if pad is None else pad
    if stride > 1 and x.shape[2] % stride:
        spatial.refuse(site, x.shape[2], f"a multiple of {stride} for its "
                       f"stride-{stride} conv")
    ext = spatial.halo(x, pad, k - 1 - pad if stride == 1 else pad, site)
    return F.conv2d(reflect_cols(ext, pad), w, stride=stride)
