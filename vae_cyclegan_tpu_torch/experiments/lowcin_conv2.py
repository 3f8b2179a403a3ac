"""K6: the channel-major low-cin conv prototype, a reflect SAME stride-1 conv
forward as k dx-shifted GEMMs per (image, R-row chunk),
``acc(cout, R*Wp) += W[dx] . patch[:, dx:dx + R*Wp]`` with K = k * cin_p.

Counterpart of ``experiments/pallas_conv2.py`` (``lowcin_conv`` ``:85``, its
``pallas_call`` ``:95``; ``prep_x`` ``:64``, ``prep_w`` ``:77``; ``main``
``:141``). The kernel (``csrc/lowcin_conv.cu``, on the NHWC conv core of
``csrc/nhwc_conv.cuh``) writes the channel-major output (n, cout, h * Wp),
all Wp columns of each row, from the reflect-padded copy of x Wp columns
wide (``common.pad_input``), which holds JAX's channel-major input
(``prep_x``) position-major; ``lowcin_conv`` slices the w real columns and
transposes to NHWC, as the JAX wrapper does in XLA. The TPU's tile sizes
become the card's: Wp = w + 2p rounded up to 8 (128 lanes there) and cin
zero-filled to 16-byte chunks (8 sublanes there). ``prep_x`` and ``prep_w``
keep JAX's layouts for the plain version and the tests.

    python -m vae_cyclegan_tpu_torch.experiments.lowcin_conv2 [--batch 24] [--device cuda]

prints per shape the relative error against the plain version, the plain
version's time (``xla=`` in JAX) and the kernel's. JAX times 16 calls in one
scan per window (``timeit_scan``, its inputs scaled per call so XLA cannot
fold them); here ITERS calls per window, back to back, of the same inputs.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from vae_cyclegan_tpu_torch.experiments.common import (
    check_conv,
    check_operands,
    conv_gflop,
    conv_operands,
    launch,
    nhwc_weight,
    pad_input,
    parse_args,
    reflect_conv_reference,
    reflect_pad_into,
    resolve_device,
    rup,
)
from vae_cyclegan_tpu_torch.experiments.timing import median_ms, ms_text
from vae_cyclegan_tpu_torch.ops.instance_norm import DTYPE_CODES

# (name, size, cin, cout, k, R): pallas_conv2.py:145-150
SHAPES = [
    ("head k7 3->64 @256", 256, 3, 64, 7, 16),
    ("U3 64->128 @128", 128, 64, 128, 3, 16),
    ("U4 32->64 @256", 256, 32, 64, 3, 16),
    ("tail k7 64->3 @256", 256, 64, 3, 7, 16),
]
ITERS = 10
CIN_ALIGN = 8   # cin_p: 16-byte runs of bf16
WP_ALIGN = 8    # Wp


def geometry(w: int, cin: int, k: int):
    """(p, cin_p, Wp, tail) of the channel-major layout."""
    p = k // 2
    return p, rup(cin, CIN_ALIGN), rup(w + 2 * p, WP_ALIGN), rup(2 * p,
                                                                 WP_ALIGN)


def prep_x(x: torch.Tensor, k: int) -> torch.Tensor:
    """NHWC -> (n, cin_p, (h + 2p) * Wp + tail): reflect pad by p, zeros to
    Wp columns and cin_p channels, each channel's padded plane flattened,
    then the zero tail that the last chunk's dx taps read into; written in
    one pass over x (a transpose to channel-major) and the zero padding."""
    n, h, wd, cin = x.shape
    p, cin_p, wp, tail = geometry(wd, cin, k)
    hp = h + 2 * p
    xf = x.new_empty((n, cin_p, hp * wp + tail))
    xf[:, cin:].zero_()
    xf[:, :cin, hp * wp:].zero_()
    planes = xf[:, :cin, :hp * wp].unflatten(2, (hp, wp))
    planes[..., wd + 2 * p:].zero_()
    reflect_pad_into(planes[..., :wd + 2 * p], x.permute(0, 3, 1, 2), p, 2, 3)
    return xf


def prep_w(w: torch.Tensor, cin_p: int) -> torch.Tensor:
    """(k, k, cin, cout) -> (k_dx, cout, k_dy * cin_p):
    wdx[dx, co, dy * cin_p + ci] = w[dy, dx, ci, co]."""
    k, _, cin, cout = w.shape
    wp = F.pad(w, (0, 0, 0, cin_p - cin))
    return wp.permute(1, 3, 0, 2).reshape(k, cout, k * cin_p).contiguous()


def lowcin_conv_cm_cuda(x: torch.Tensor, w: torch.Tensor,
                        R: int) -> torch.Tensor:
    """Launch K6 on contiguous NHWC x and HWIO w (k, k, cin, cout) on one CUDA
    device, both float32 or both bfloat16, odd k, R dividing h: pad_input at
    Wp columns and the weight in K7's order (``nhwc_weight``, dx outermost),
    then the kernel (csrc/lowcin_conv.cu). Returns its channel-major output
    (n, cout, h * Wp) in x's dtype, every Wp column of each row (the w real
    ones first). Not differentiable: raises under autograd. Shared memory as
    ``common.launch_nhwc`` says; a shape past it fails to launch
    (RuntimeError)."""
    name = "lowcin_conv_cm"
    check_operands(name, x, w)
    check_conv(name, x, w, R)
    n, h, wd, cin = x.shape
    k, _, _, cout = w.shape
    _, _, wp, _ = geometry(wd, cin, k)
    xp = pad_input(x, k, wp)
    wk, fold = nhwc_weight(w, dx_outer=True)
    y = torch.empty((n, cout, h * wp), dtype=x.dtype, device=x.device)
    launch("vct_lowcin_conv", x.device, xp.data_ptr(), wk.data_ptr(),
           y.data_ptr(), n, h, wd, cin, cout, k, wp, int(fold),
           DTYPE_CODES[x.dtype])
    lowcin_conv_cm_cuda.launches += 1
    return y


lowcin_conv_cm_cuda.launches = 0


def lowcin_conv_cm_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K6 in its own output layout: (n, cout, h * Wp), each
    position the f32 sum over the taps (dy, dx) of the flat channel-major
    input at (r + dy) * Wp + c + dx, which for the columns c >= w wraps into
    the next row as the kernel does; one rounding to x's dtype. It is
    ``F.conv2d`` over a strided view of prep_x's output whose rows run k - 1
    elements into the next row."""
    n, h, wd, cin = x.shape
    k, _, _, cout = w.shape
    p, cin_p, wp, _ = geometry(wd, cin, k)
    xf = prep_x(x, k).float()
    xlen = xf.shape[-1]
    rows = xf.as_strided((n, cin_p, h + 2 * p, wp + k - 1),
                         (cin_p * xlen, xlen, wp, 1))
    wt = F.pad(w.float(), (0, 0, 0, cin_p - cin)).permute(3, 2, 0, 1)
    y = F.conv2d(rows.contiguous(), wt)
    return y.reshape(n, cout, h * wp).to(x.dtype)


def lowcin_conv(x: torch.Tensor, w: torch.Tensor, R: int = 16) -> torch.Tensor:
    """Reflect SAME stride-1 conv of NHWC x with HWIO w, NHWC out: K6 (or its
    plain version on the CPU) in the channel-major layout, then the w real
    columns transposed to NHWC."""
    check_conv("lowcin_conv_cm", x, w, R)
    if x.device.type == "cuda":
        cm = lowcin_conv_cm_cuda(x, w, R)
    else:
        cm = lowcin_conv_cm_reference(x, w)
    n, h, wd, _ = x.shape
    cout = w.shape[-1]
    out = cm.reshape(n, cout, h, cm.shape[-1] // h)[:, :, :, :wd]
    return out.permute(0, 2, 3, 1).contiguous()


def run_shapes(fn, title: str, argv: Optional[List[str]], shapes) -> List[dict]:
    """The main of the two channel-major prototypes (pallas_conv2.py:141,
    pallas_conv3.py:144): per shape the relative error of `fn` against the
    plain version, the plain version's time and the kernel's. Returns one
    dict per shape, with ``calls``, the number of `fn` calls it made."""
    args = parse_args(argv, title)
    device = resolve_device(args.device)
    dtype = torch.bfloat16
    print(f"batch={args.batch} bf16 device={device}", flush=True)
    results = []
    for name, s, cin, cout, k, R in shapes:
        x, w = conv_operands(args.batch, s, cin, cout, k, device, dtype)
        calls = [0]

        def run():
            calls[0] += 1
            return fn(x, w, R)

        got = run().float()
        want = reflect_conv_reference(x, w).float()
        err = float((got - want).abs().max())
        scale = float(want.abs().max()) or 1.0
        t_ref = median_ms(lambda: reflect_conv_reference(x, w), device, ITERS)
        t_new = median_ms(run, device, ITERS)
        gflop = conv_gflop(args.batch, s, cin, cout, k)
        rate = "" if t_new is None else f" ({gflop / t_new:6.1f} TF/s)"
        print(f"{name:20s} relerr={err / scale:.2e}  plain={ms_text(t_ref)} "
              f"kernel={ms_text(t_new)}{rate}", flush=True)
        results.append({"name": name, "x": tuple(x.shape),
                        "w": tuple(w.shape), "R": R, "relerr": err / scale,
                        "plain_ms": t_ref, "ms": t_new, "calls": calls[0]})
    return results


def main(argv: Optional[List[str]] = None, shapes=SHAPES) -> List[dict]:
    return run_shapes(lowcin_conv, "K6, the channel-major conv prototype "
                      "(pallas_conv2)", argv, shapes)


if __name__ == "__main__":
    main()
