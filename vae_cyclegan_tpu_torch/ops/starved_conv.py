"""Reflect-padded SAME convolution for the big-spatial, low-channel shapes,
with its exact gradient.

Dispatch follows the JAX package exactly (``vae_cyclegan_tpu/ops/
starved_conv.py``): a stride-1, odd-k conv whose shape passes ``supported``
(``_supported``) runs as one ``torch.autograd.Function`` (``_StarvedConv``,
the counterpart of ``_starved_conv_cm``) whose saved tensors are only
``(x, w)``:

  * forward: the reflect conv kernel where the kernel wins the forward
    (``fwd_wins``, ``_fwd_wins``: cin >= 8), else the plain conv, as JAX
    keeps the cin=3 head's forward on XLA;
  * dx: the zero_same conv kernel with the rotated weight, plus the
    reflect-adjoint fold of its p-wide borders (``dx_with_border_fold``,
    ``_dx_with_border_fold``), whose strip convs stay plain ``F.conv2d`` as
    JAX runs them in XLA; computed only where x needs a gradient;
  * dw: the weight-gradient kernel (``dw_cuda``, ``_dw_call``), in f32 and
    then cast to w's dtype, as JAX does.

The kernels live in ``csrc/starved_conv.cu`` (all three padding modes of
``_conv_call``) and ``csrc/starved_dw.cu``. On the training path the
reflect forward runs at U4 (k3, 32->64) and the tail (k7, 64->3), dx at U4,
the tail and, where the input needs a gradient, the head (k7, 3->64), and dw
at all three, at 256x256. Every other conv takes the plain version,
``reflect_conv``, and autograd. The kernels are reached through the custom
operators ``vct::starved_conv`` (K3, by padding mode) and ``vct::starved_dw``
(K4) of ``kernels.ops``, whose dispatch picks the implementation by device:
a CUDA tensor that the rule selects launches the kernel or raises; CPU
tensors take the plain versions, ``meta`` tensors the operators' fakes. A
call that needs no gradient runs the forward without the Function.

The JAX package's channel-major entry points and ``VCT_*`` knobs steer TPU
layouts and tiles; they have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.kernels import ops as kernel_ops
from vae_cyclegan_tpu_torch.ops.instance_norm import DTYPE_CODES
from vae_cyclegan_tpu_torch.ops.padding import reflect_pad
from vae_cyclegan_tpu_torch.ops.reflect_conv import reflect_conv

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# padding modes of csrc/starved_conv.cu
PAD_MODES = {"reflect": 0, "zero_same": 1, "zero": 2}


def supported(x_shape, w_shape, dtype) -> bool:
    """The starved shapes (``_supported`` of the JAX package): NCHW x, OIHW
    w, square odd k > 1, one side's channels <= 32, the other <= 512, and
    H, W >= 32 and divisible by 8."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    cout, cin, k, k2 = w_shape
    _, cx, h, wd = x_shape
    if k != k2 or k % 2 == 0 or k == 1 or cx != cin:
        return False
    if dtype not in _KERNEL_DTYPES:
        return False
    if min(cin, cout) > 32 or max(cin, cout) > 512:
        return False
    if h < 32 or wd < 32 or h % 8 or wd % 8:
        return False
    return True


def fwd_wins(k: int, cin: int, cout: int) -> bool:
    """Forward choice per shape class (``_fwd_wins``): the kernel takes the
    forward when cin >= 8; the cin=3 head stays on the plain conv."""
    return cin >= 8


def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{name} kernel needs both tensors on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"{name} kernel takes float32/bfloat16 tensors of "
                        f"one dtype, got {a.dtype} and {b.dtype}")
    if a.dim() != 4 or b.dim() != 4 or not (a.is_contiguous()
                                            and b.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous 4-d tensors")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError(f"{name} kernel is not differentiable itself; "
                           "call starved_reflect_conv for the conv with its "
                           "gradient")


def _conv_launch(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    _check_pair("starved conv", x, w)
    n, cin, h, wd = x.shape
    cout, cin_w, k, k2 = w.shape
    grow = k - 1 if mode == "zero" else 0
    if (cin_w != cin or k != k2 or k % 2 == 0 or n == 0 or n > 65535
            or (mode == "reflect" and k // 2 >= min(h, wd))):
        raise ValueError(f"starved conv kernel ({mode}) cannot take x "
                         f"{tuple(x.shape)} with w {tuple(w.shape)}")
    lib = kernels.load()
    y = torch.empty((n, cout, h + grow, wd + grow), dtype=x.dtype,
                    device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vct_starved_conv(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  n, cin, cout, h, wd, k, PAD_MODES[mode],
                                  DTYPE_CODES[x.dtype], stream)
    kernels.check(rc, f"starved_conv ({mode})")
    return y


def reflect_conv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the conv kernel in reflect mode: contiguous NCHW x and OIHW w
    on one CUDA device, both float32 or both bfloat16, odd k. No bias. Not
    differentiable itself: raises under autograd."""
    y = _conv_launch(x, w, "reflect")
    reflect_conv_cuda.launches += 1
    return y


reflect_conv_cuda.launches = 0


def zero_conv_cuda(x: torch.Tensor, w: torch.Tensor,
                   mode: str = "zero_same") -> torch.Tensor:
    """Launch the conv kernel in a zero-padded mode: ``"zero_same"`` (pad
    k//2, output h x w; the core of dx) or ``"zero"`` (the full correlation,
    pad k-1, output (h+k-1) x (w+k-1)). Same tensor rules as
    ``reflect_conv_cuda``; one launch counter for both modes."""
    if mode not in ("zero_same", "zero"):
        raise ValueError(f"unknown zero padding mode {mode}")
    y = _conv_launch(x, w, mode)
    zero_conv_cuda.launches += 1
    return y


zero_conv_cuda.launches = 0


def zero_conv(x: torch.Tensor, w: torch.Tensor,
              mode: str = "zero_same") -> torch.Tensor:
    """Plain version of ``zero_conv_cuda``: zero-padded ``F.conv2d``."""
    k = w.shape[-1]
    return F.conv2d(x, w, padding=k - 1 if mode == "zero" else k // 2)


def dw_cuda(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the weight-gradient kernel: dw (cout, cin, k, k) in float32 of
    the reflect-SAME conv, from contiguous NCHW x (n, cin, h, w) and output
    gradient g (n, cout, h, w) of one dtype on one CUDA device."""
    _check_pair("starved dw", x, g)
    n, cin, h, wd = x.shape
    cout = g.shape[1]
    if g.shape != (n, cout, h, wd):
        raise ValueError(f"starved dw kernel: g {tuple(g.shape)} does not "
                         f"match x {tuple(x.shape)}")
    lib = kernels.load()
    floats = lib.vct_dw_scratch_floats(n, cin, cout, h, wd, k)
    if floats < 0:
        raise ValueError(f"starved dw kernel cannot take x {tuple(x.shape)} "
                         f"with k {k}")
    dw = torch.empty((cout, cin, k, k), dtype=torch.float32, device=x.device)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vct_starved_dw(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                                scratch.data_ptr(), n, cin, cout, h, wd, k,
                                DTYPE_CODES[x.dtype], stream)
    kernels.check(rc, "starved_dw")
    dw_cuda.launches += 1
    return dw


dw_cuda.launches = 0


def dw_reference(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of ``dw_cuda``: ``conv2d_weight`` on the reflect-padded
    x, in float32 (products of bf16 values are exact in f32)."""
    return torch.nn.grad.conv2d_weight(
        reflect_pad(x.float(), k // 2), (g.shape[1], x.shape[1], k, k),
        g.float())


# ---------------------------------------------------------------------------
# the dispatch of each kernel's call sites
# ---------------------------------------------------------------------------


def _zero_same(g: torch.Tensor, wrot: torch.Tensor) -> torch.Tensor:
    k = wrot.shape[-1]
    kernels.note_site("starved_conv_dx", g.shape, g.dtype, k=k,
                      cin=wrot.shape[1], cout=wrot.shape[0])
    return kernel_ops.starved_conv(g, wrot, "zero_same")


def _dw(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    kernels.note_site("starved_conv_dw", x.shape, x.dtype, k=k,
                      cin=x.shape[1], cout=g.shape[1])
    return kernel_ops.starved_dw(x, g, k)


def rotate(w: torch.Tensor) -> torch.Tensor:
    """The dx conv's weight: OIHW w flipped in both taps, in and out
    channels swapped (``w[::-1, ::-1].transpose(0, 1, 3, 2)`` in HWIO)."""
    return w.flip(2, 3).transpose(0, 1)


def _full_corr(s: torch.Tensor, wrot: torch.Tensor) -> torch.Tensor:
    """Zero-padded full correlation of a small strip (``_full_corr_cm``)."""
    k = wrot.shape[-1]
    return F.conv2d(s, wrot, padding=k - 1)


def _row_fold(t, fix_t, fix_b, p: int, h: int) -> torch.Tensor:
    return torch.cat([t[:, :, 0:1], t[:, :, 1:p + 1] + fix_t,
                      t[:, :, p + 1:h - p - 1],
                      t[:, :, h - p - 1:h - 1] + fix_b, t[:, :, h - 1:h]],
                     dim=2)


def dx_with_border_fold(g: torch.Tensor, wrot: torch.Tensor) -> torch.Tensor:
    """dx of the reflect-SAME conv (``_dx_with_border_fold``): the zero_same
    conv of g with the rotated weight (the interior of the fold, one kernel
    launch) plus the reflect-adjoint corrections of the p-wide borders,
    from four strip convs. Equal to ``reflect_fold(zero_conv(g, wrot,
    "zero"), p)`` without the (h+2p, w+2p) correlation in memory."""
    k = wrot.shape[-1]
    p = k // 2
    h, w_ = g.shape[2], g.shape[3]
    core = _zero_same(g, wrot)
    if p == 0:
        return core
    top = _full_corr(g[:, :, :p], wrot)[:, :, :p]             # A[0:p]
    bot = _full_corr(g[:, :, h - p:], wrot)[:, :, 2 * p:]     # A[h+p:h+2p]
    left = _full_corr(g[..., :p], wrot)[..., :p]              # A[:, 0:p]
    right = _full_corr(g[..., w_ - p:], wrot)[..., 2 * p:]
    rtop = top.flip(2)    # rtop[i] = A[p-1-i]: row r=1+i adds A[p-r]
    rbot = bot.flip(2)    # rbot[i] = A[h+2p-1-i]: row h-p-1+i adds it
    out = _row_fold(core, rtop[..., p:p + w_], rbot[..., p:p + w_], p, h)
    # the column fold acts on the row-folded tensor: fold the rows of the
    # full-height column strips first (corner terms), then mirror columns
    lb = _row_fold(left[:, :, p:h + p], rtop[..., :p], rbot[..., :p], p, h)
    rb = _row_fold(right[:, :, p:h + p], rtop[..., p + w_:],
                   rbot[..., p + w_:], p, h)
    return torch.cat([out[..., 0:1], out[..., 1:p + 1] + lb.flip(3),
                      out[..., p + 1:w_ - p - 1],
                      out[..., w_ - p - 1:w_ - 1] + rb.flip(3),
                      out[..., w_ - 1:w_]], dim=3)


def reflect_fold(gp: torch.Tensor, pad: int) -> torch.Tensor:
    """Adjoint of reflect padding (``_reflect_fold_cm``): fold an
    (n, c, h+2p, w+2p) gradient back onto (n, c, h, w). The oracle of
    ``dx_with_border_fold``."""
    if pad == 0:
        return gp
    hp, wp_ = gp.shape[2], gp.shape[3]
    h = hp - 2 * pad
    core = gp[:, :, pad:hp - pad]
    gp = torch.cat([core[:, :, 0:1],
                    core[:, :, 1:pad + 1] + gp[:, :, :pad].flip(2),
                    core[:, :, pad + 1:h - pad - 1],
                    core[:, :, h - pad - 1:h - 1]
                    + gp[:, :, hp - pad:].flip(2),
                    core[:, :, h - 1:h]], dim=2)
    w = wp_ - 2 * pad
    core = gp[..., pad:wp_ - pad]
    return torch.cat([core[..., 0:1],
                      core[..., 1:pad + 1] + gp[..., :pad].flip(3),
                      core[..., pad + 1:w - pad - 1],
                      core[..., w - pad - 1:w - 1]
                      + gp[..., wp_ - pad:].flip(3),
                      core[..., w - 1:w]], dim=3)


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The starved conv's forward: K3 in reflect mode where ``fwd_wins``,
    else the plain conv."""
    cout, cin, k, _ = w.shape
    if not fwd_wins(k, cin, cout):
        return reflect_conv(x, w)
    kernels.note_site("starved_conv", x.shape, x.dtype, k=k, cin=cin,
                      cout=cout)
    return kernel_ops.starved_conv(x, w, "reflect")


class _StarvedConv(torch.autograd.Function):
    """The reflect-SAME conv of the starved shapes with its exact gradient;
    saves only (x, w)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, gy: torch.Tensor
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dx_with_border_fold(g, rotate(w))
        if ctx.needs_input_grad[1]:
            dw = _dw(x, g, w.shape[-1]).to(w.dtype)
        return dx, dw


def starved_reflect_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reflect-padded SAME conv (stride 1, odd k, NCHW x, OIHW w, no bias),
    differentiable: the starved shapes go through the kernels (forward where
    ``fwd_wins``, both gradients always), the rest to ``reflect_conv``."""
    if not supported(x.shape, w.shape, x.dtype):
        return reflect_conv(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _StarvedConv.apply(x, w)
    return _forward(x, w)
