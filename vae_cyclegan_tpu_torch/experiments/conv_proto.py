"""K5: the NHWC direct-conv prototype, a reflect SAME stride-1 conv forward as
one implicit GEMM per (image, R-row chunk) with K = k*k*cin.

Counterpart of ``experiments/pallas_conv_proto.py`` (``pallas_reflect_conv_fwd``
``:51``, its ``pallas_call`` ``:67``; ``main`` ``:106``). The wrapper
reflect-pads the NHWC input and adds one zero row, as the JAX wrapper does in
XLA (``:56-62``), and ``csrc/conv_proto.cu`` (the NHWC conv core of
``csrc/nhwc_conv.cuh`` with a loader of the padded rows) does the GEMM,
writing only the w real columns of each row (the TPU kernel writes the 2p
wrap-around columns too and XLA slices them off).

    python -m vae_cyclegan_tpu_torch.experiments.conv_proto [--batch 24] [--device cuda]

prints per shape the error against the plain version, ``cur`` (the port's
``ops.reflect_conv.reflect_conv``: pad + cuDNN, the counterpart of JAX's
``reflect_conv``) and the kernel's time and TF/s. Fewer timed calls than the
JAX script (ITERS per window, 20 there).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from vae_cyclegan_tpu_torch.experiments.common import (
    check_conv,
    check_operands,
    conv_gflop,
    conv_operands,
    launch_nhwc,
    pad_input,
    parse_args,
    reflect_conv_reference,
    resolve_device,
)
from vae_cyclegan_tpu_torch.experiments.timing import median_ms, ms_text
from vae_cyclegan_tpu_torch.ops.reflect_conv import reflect_conv

# (name, size, cin, cout, k, R): pallas_conv_proto.py:109-114
SHAPES = [
    ("head k7 3->64 @256", 256, 3, 64, 7, 16),
    ("U3 64->128 @128", 128, 64, 128, 3, 32),
    ("U4 32->64 @256", 256, 32, 64, 3, 32),
    ("tail k7 64->3 @256", 256, 64, 3, 7, 8),
]
ITERS = 10


def conv_proto_cuda(x: torch.Tensor, w: torch.Tensor, R: int) -> torch.Tensor:
    """Launch K5: contiguous NHWC x and HWIO w (k, k, cin, cout) on one CUDA
    device, both float32 or both bfloat16, odd k, R dividing h. pad_input,
    then the kernel (csrc/conv_proto.cu, on the NHWC conv core), which reads
    the padded copy; NHWC out in x's dtype. Not differentiable: raises under
    autograd. Shared memory as ``launch_nhwc`` says."""
    check_operands("conv_proto", x, w)
    check_conv("conv_proto", x, w, R)
    y = launch_nhwc("vct_conv_proto", pad_input(x, w.shape[0]), x, w,
                    dx_outer=False)
    conv_proto_cuda.launches += 1
    return y


conv_proto_cuda.launches = 0


def pallas_reflect_conv_fwd(x: torch.Tensor, w: torch.Tensor,
                            R: int = 32) -> torch.Tensor:
    """Reflect SAME stride-1 conv of NHWC x with HWIO w, NHWC out: K5 on a
    CUDA tensor, the plain version on the CPU."""
    check_conv("conv_proto", x, w, R)
    if x.device.type == "cuda":
        return conv_proto_cuda(x, w, R)
    return reflect_conv_reference(x, w)


def main(argv: Optional[List[str]] = None, shapes=SHAPES) -> List[dict]:
    """Per shape: the kernel against the plain version, the times of cur and
    the kernel. Returns one dict per shape, with ``calls``, the number of
    ``pallas_reflect_conv_fwd`` calls it made (each one K5 launch on the
    card)."""
    args = parse_args(argv, "K5, the NHWC conv prototype (pallas_conv_proto)")
    device = resolve_device(args.device)
    dtype = torch.bfloat16
    print(f"batch={args.batch} bf16 device={device}", flush=True)
    results = []
    for name, s, cin, cout, k, R in shapes:
        x, w = conv_operands(args.batch, s, cin, cout, k, device, dtype)
        calls = [0]

        def run():
            calls[0] += 1
            return pallas_reflect_conv_fwd(x, w, R)

        got = run()
        want = reflect_conv_reference(x, w)
        err = float((got.float() - want.float()).abs().max())
        xn = x.permute(0, 3, 1, 2).contiguous()
        wn = w.permute(3, 2, 0, 1).contiguous()
        t_cur = median_ms(lambda: reflect_conv(xn, wn), device, ITERS)
        t_new = median_ms(run, device, ITERS)
        gflop = conv_gflop(args.batch, s, cin, cout, k)
        rate = "" if t_new is None else f"  ({gflop / t_new:6.1f} TF/s)"
        print(f"{name:20s} err={err:.2e}  cur={ms_text(t_cur)} "
              f"kernel={ms_text(t_new)}{rate}", flush=True)
        results.append({"name": name, "x": tuple(x.shape),
                        "w": tuple(w.shape), "R": R, "err": err,
                        "cur_ms": t_cur, "ms": t_new, "calls": calls[0]})
    return results


if __name__ == "__main__":
    main()
