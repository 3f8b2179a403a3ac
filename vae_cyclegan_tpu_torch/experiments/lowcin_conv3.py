"""K7: the low-cin conv prototype with the NHWC output written by the kernel
itself.

Counterpart of ``experiments/pallas_conv3.py`` (``lowcin_conv`` ``:87``, its
``pallas_call`` ``:100``; ``main`` ``:144``): K6's math (the k dx-shifted
GEMMs, K ordered dx outermost, then (dy, ci)) with the NHWC output stored by
the kernel, the w real columns only, on one flat grid with the next chunk's
slab double-buffered (``:33-57``). Here ``csrc/lowcin_nhwc.cu``, the NHWC
conv core of ``csrc/nhwc_conv.cuh``: persistent blocks walk the flat
(image, row, column tile) space with a two-stage cp.async slab ring, and the
loader reads NHWC x itself, reflecting each chunk's source position. The
channel-major copy of x (``lowcin_conv2.prep_x``) served the TPU's lane
tiling and is not made.

    python -m vae_cyclegan_tpu_torch.experiments.lowcin_conv3 [--batch 24] [--device cuda]

prints what ``lowcin_conv2`` prints, at the JAX script's three shapes.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from vae_cyclegan_tpu_torch.experiments.common import (
    check_conv,
    check_operands,
    launch_nhwc,
    reflect_conv_reference,
)
from vae_cyclegan_tpu_torch.experiments.lowcin_conv2 import run_shapes

# (name, size, cin, cout, k, R): pallas_conv3.py:148-152
SHAPES = [
    ("head k7 3->64 @256", 256, 3, 64, 7, 16),
    ("U3 64->128 @128", 128, 64, 128, 3, 16),
    ("U4 32->64 @256", 256, 32, 64, 3, 16),
]


def lowcin_conv_nhwc_cuda(x: torch.Tensor, w: torch.Tensor,
                          R: int) -> torch.Tensor:
    """Launch K7 on contiguous NHWC x and HWIO w (k, k, cin, cout) on one CUDA
    device, both float32 or both bfloat16, odd k, R dividing h: the kernel
    reads x as it lies (no padded or channel-major copy) and writes NHWC
    (n, h, w, cout) in x's dtype. Not differentiable: raises under autograd.
    Shared memory as ``launch_nhwc`` says."""
    check_operands("lowcin_conv_nhwc", x, w)
    check_conv("lowcin_conv_nhwc", x, w, R)
    y = launch_nhwc("vct_lowcin_nhwc", x, x, w, dx_outer=True)
    lowcin_conv_nhwc_cuda.launches += 1
    return y


lowcin_conv_nhwc_cuda.launches = 0


def lowcin_conv(x: torch.Tensor, w: torch.Tensor, R: int = 16) -> torch.Tensor:
    """Reflect SAME stride-1 conv of NHWC x with HWIO w, NHWC out: K7 on a
    CUDA tensor, the plain version (``reflect_conv_reference``, the same
    function in the same layout) on the CPU."""
    check_conv("lowcin_conv_nhwc", x, w, R)
    if x.device.type == "cuda":
        return lowcin_conv_nhwc_cuda(x, w, R)
    return reflect_conv_reference(x, w)


def main(argv: Optional[List[str]] = None, shapes=SHAPES) -> List[dict]:
    return run_shapes(lowcin_conv, "K7, the low-cin conv prototype with NHWC "
                      "out (pallas_conv3)", argv, shapes)


if __name__ == "__main__":
    main()
