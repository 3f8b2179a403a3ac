"""K7: the channel-major low-cin conv prototype with the NHWC output written
by the kernel itself.

Counterpart of ``experiments/pallas_conv3.py`` (``lowcin_conv`` ``:87``, its
``pallas_call`` ``:100``; ``main`` ``:144``). K6's math (``lowcin_conv2``:
the same channel-major input, ``prep_x`` and ``prep_w``, and the k
dx-shifted GEMMs) in ``csrc/lowcin_conv.cu``'s NHWC mode: each chunk's
(cout, R*Wp) result is stored as NHWC (n, h, w, cout), the w real columns
only, so there is no slice or transpose after it. The TPU kernel also runs
one flat grid over (n, chunk) and double-buffers the next chunk's slab DMAs
(``:33-57``); on the card the blocks of all chunks run at once, and the
kernel overlaps only each chunk's next K step's loads with its current one
(the two-stage cp.async slab pipeline is not built: ``ROADMAP.md``).

    python -m vae_cyclegan_tpu_torch.experiments.lowcin_conv3 [--batch 24] [--device cuda]

prints what ``lowcin_conv2`` prints, at the JAX script's three shapes.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from vae_cyclegan_tpu_torch.experiments.common import (
    check_conv,
    reflect_conv_reference,
)
from vae_cyclegan_tpu_torch.experiments.lowcin_conv2 import (  # noqa: F401
    launch_lowcin,
    prep_w,
    prep_x,
    run_shapes,
)

# (name, size, cin, cout, k, R): pallas_conv3.py:148-152
SHAPES = [
    ("head k7 3->64 @256", 256, 3, 64, 7, 16),
    ("U3 64->128 @128", 128, 64, 128, 3, 16),
    ("U4 32->64 @256", 256, 32, 64, 3, 16),
]


def lowcin_conv_nhwc_cuda(x: torch.Tensor, w: torch.Tensor,
                          R: int) -> torch.Tensor:
    """Launch K7 on contiguous NHWC x and HWIO w (k, k, cin, cout) on one CUDA
    device, both float32 or both bfloat16, odd k, R dividing h: prep_x and
    prep_w, then the kernel, which writes NHWC (n, h, w, cout) in x's dtype.
    Not differentiable: raises under autograd."""
    y = launch_lowcin("lowcin_conv_nhwc", x, w, R, nhwc=True)
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
    return run_shapes(lowcin_conv, "K7, the channel-major conv prototype with "
                      "NHWC out (pallas_conv3)", argv, shapes)


if __name__ == "__main__":
    main()
