"""Reflection padding for NCHW tensors (every conv of the reference pads
with ``mode='reflect'``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the two spatial dims of an NCHW tensor by `pad` pixels."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def reflect_rows(ext: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """`top` reflect rows above and `bottom` below an NCHW strip, each from
    the strip itself: row -i is row i and row L-1+i is row L-1-i, as
    ``reflect_pad`` builds them. Spatial parallelism calls it at the image's
    true borders on the extended strip (a rank's rows plus its neighbour's
    halo, ``parallel.spatial.halo``), so a strip of one own row reflects
    from the neighbour's rows."""
    length = ext.shape[2]
    if max(top, bottom) >= length:
        raise ValueError(f"reflect rows: {top}/{bottom} rows of a strip of "
                         f"{length} rows (at most {length - 1})")
    parts = [ext]
    if top:
        parts.insert(0, ext[:, :, 1:top + 1].flip(2))
    if bottom:
        parts.append(ext[:, :, length - 1 - bottom:length - 1].flip(2))
    return torch.cat(parts, dim=2) if len(parts) > 1 else ext


def reflect_cols(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the width of an NCHW tensor only (the rows of a spatial
    shard come padded by ``parallel.spatial.halo``)."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, 0, 0), mode="reflect")
