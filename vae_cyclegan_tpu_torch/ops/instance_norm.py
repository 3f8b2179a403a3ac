"""Fused InstanceNorm + activation, the reference's per-layer pattern.

Semantics match ``torch.nn.InstanceNorm2d`` defaults: biased variance,
eps=1e-5, no affine parameters, statistics in float32. Two orders:

  * ``norm_act``: InstanceNorm then activation (CaSb)
  * ``act_norm``: activation then InstanceNorm (D/R/U blocks)

Dispatch follows the JAX package's rule (``vae_cyclegan_tpu/ops/
instance_norm.py::instance_norm_act``), by ``mode``, the counterpart of its
``use_pallas``:

  * ``"auto"`` (JAX's None): a slab whose per-sample f32 size H*W*C*4 is at
    most 1 MB takes the one-pass kernel (``csrc/in_act.cu``, the port of
    ``_pallas_in_act``); larger slabs take the plain version, as JAX sends
    them to XLA. In a generator forward the kernel runs at the five
    16x16x1024 sites, in a discriminator forward at the 32x32x256 and
    16x16x512 sites.
  * ``"tiled"`` (JAX's "tiled"): every site takes the tiled kernel
    (``csrc/in_act_tiled.cu``, the port of ``_pallas_in_act_tiled``), whose
    statistics are single-pass (var = max(E[h^2] - mean^2, 0)) and which
    rounds once, after the activation and the norm. Where ``tile_rows``
    does not divide H*W the JAX kernel falls back to ``_fused_reference``,
    and so does the port.
  * ``"plain"``: the plain version whatever the size; the Decoder's U4 site
    under "tiled" when JAX hands that site over channel-major (it then
    normalizes it on XLA).

Both kernels share ``csrc/in_plane.cuh``: each plane is read from device
memory once, held on chip (a warp, a CTA or a thread block cluster per
plane, by its size) and written once, in one launch; they differ only in the
variance formula.

A CUDA tensor that the rule selects launches the kernel or raises; CPU and
``meta`` tensors take the plain version.

Every path is a ``torch.autograd.Function`` whose backward is plain torch in
f32, returning x's dtype, as the JAX package's custom VJPs are jnp:
``_InActFused`` (K1's sites, ``_fused_tpu``) and ``_InActTiled`` (K2's,
``_fused_tpu_tiled``) save x and recompute centered statistics
(``_fused_tpu_bwd``), so K2's forward and backward use different variance
formulas, as in JAX; ``_InActPlain`` (the big slabs, ``_fused_xla``) saves
(x, mean, rsqrt) and takes the analytic form (``_fused_xla_bwd``). The
plain forwards keep the centered variance of the serving path and of the
JAX package's CPU path; on the TPU, JAX's training forward of the big slabs
uses the single-pass E[x^2] - mean^2 (``_stats``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from vae_cyclegan_tpu_torch import kernels

EPS = 1e-5
SLAB_BYTES = 1024 * 1024

ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "leaky_relu": lambda x: torch.where(x >= 0, x, 0.2 * x),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}
ORDERS = ("norm_act", "act_norm")
MODES = ("auto", "tiled", "plain")
# codes of csrc/common.cuh
_ACT_CODES = {"relu": 0, "leaky_relu": 1, "tanh": 2, "sigmoid": 3,
              "identity": 4}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _stats(h: torch.Tensor, eps: float):
    """Per-(n, c) mean and rsqrt(centered biased variance + eps) of an f32
    NCHW tensor."""
    mu = h.mean(dim=(2, 3), keepdim=True)
    var = (h - mu).square().mean(dim=(2, 3), keepdim=True)
    return mu, torch.rsqrt(var + eps)


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Plain InstanceNorm of an NCHW tensor (stats per (n, c) in f32,
    centered biased variance), returned in x's dtype."""
    xf = x.float()
    mu, r = _stats(xf, eps)
    return ((xf - mu) * r).to(x.dtype)


def _fused_with_stats(x: torch.Tensor, act: str, order: str, eps: float):
    """(y, mean, rsqrt) of the fused op, y as ``fused_reference``."""
    f = ACTS[act]
    if order == "norm_act":
        xf = x.float()
        mu, r = _stats(xf, eps)
        return f(((xf - mu) * r).to(x.dtype).float()).to(x.dtype), mu, r
    if order == "act_norm":
        h = f(x.float()).to(x.dtype).float()
        mu, r = _stats(h, eps)
        return ((h - mu) * r).to(x.dtype), mu, r
    raise ValueError(f"unknown order {order}")


def fused_reference(x: torch.Tensor, act: str, order: str,
                    eps: float = EPS) -> torch.Tensor:
    """Plain version of the fused op (``_fused_reference`` of the JAX
    package, rounding to x's dtype between the activation and the norm
    the same way)."""
    return _fused_with_stats(x, act, order, eps)[0]


def _act_and_grad(act: str, x: torch.Tensor):
    """The activation and its derivative (``_act_and_grad``)."""
    if act == "relu":
        return torch.relu(x), (x > 0).to(x.dtype)
    if act == "leaky_relu":
        pos = x >= 0
        return (torch.where(pos, x, 0.2 * x),
                torch.where(pos, 1.0, 0.2).to(x.dtype))
    if act == "tanh":
        t = torch.tanh(x)
        return t, 1.0 - t * t
    if act == "sigmoid":
        s = torch.sigmoid(x)
        return s, s * (1.0 - s)
    if act == "identity":
        return x, torch.ones_like(x)
    raise ValueError(act)


def _mean(t: torch.Tensor) -> torch.Tensor:
    return t.mean(dim=(2, 3), keepdim=True)


def _in_vjp(h: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """VJP of (h - mean(h)) * rsqrt(var(h) + eps) per (n, c) plane
    (``_in_vjp``)."""
    mu, r = _stats(h, eps)
    h_hat = (h - mu) * r
    return r * (g - _mean(g) - h_hat * _mean(g * h_hat))


def fused_backward(x: torch.Tensor, g: torch.Tensor, act: str, order: str,
                   eps: float = EPS) -> torch.Tensor:
    """dx of the fused op from x alone, in f32, returned in x's dtype
    (``_fused_tpu_bwd``)."""
    xf, gf = x.float(), g.float()
    if order == "norm_act":
        mu, r = _stats(xf, eps)
        _, dact = _act_and_grad(act, (xf - mu) * r)
        dx = _in_vjp(xf, gf * dact, eps)
    else:
        h, dact = _act_and_grad(act, xf)
        dx = _in_vjp(h, gf, eps) * dact
    return dx.to(x.dtype)


def fused_backward_from_stats(x: torch.Tensor, mu: torch.Tensor,
                              r: torch.Tensor, g: torch.Tensor, act: str,
                              order: str) -> torch.Tensor:
    """dx of the fused op from x and the forward's f32 (mean, rsqrt),
    returned in x's dtype (``_fused_xla_bwd``)."""
    xf, gf = x.float(), g.float()
    if order == "norm_act":
        x_hat = (xf - mu) * r
        _, dact = _act_and_grad(act, x_hat)
        dh = gf * dact
        dx = r * (dh - _mean(dh) - x_hat * _mean(dh * x_hat))
    else:
        h, dact = _act_and_grad(act, xf)
        h_hat = (h - mu) * r
        dx = r * (gf - _mean(gf) - h_hat * _mean(gf * h_hat)) * dact
    return dx.to(x.dtype)


def slab_fits(shape) -> bool:
    """The kernel rule: one sample's (C, H, W) slab is at most 1 MB in f32
    (``_slab_fits_vmem`` of the JAX package)."""
    _, c, h, w = shape
    return h * w * c * 4 <= SLAB_BYTES


def tile_rows(hw: int, c: int) -> int:
    """The row tile of JAX's tiled kernel (``_tile_rows``): the largest
    power-of-two fraction of hw whose f32 tile fits the slab budget, at
    least 8."""
    t = hw
    while t > 8 and t * c * 4 > SLAB_BYTES:
        t //= 2
    return t


def tiles_fit(shape) -> bool:
    """Whether JAX's tiled kernel runs for an NCHW shape: its tile divides
    H*W. Otherwise it falls back to ``_fused_reference``."""
    _, c, h, w = shape
    return (h * w) % tile_rows(h * w, c) == 0


def tiled_reference(x: torch.Tensor, act: str, order: str,
                    eps: float = EPS) -> torch.Tensor:
    """Plain version of the tiled kernel (``_pallas_in_act_tiled``): per
    (n, c) plane, in f32, the sums of h and h^2 (h = act(x) for act_norm),
    var = max(E[h^2] - mean^2, 0), and one rounding to x's dtype after the
    activation and the norm."""
    f = ACTS[act]
    h = x.float()
    if order == "act_norm":
        h = f(h)
    hw = h.shape[2] * h.shape[3]
    mu = h.sum(dim=(2, 3), keepdim=True) / hw
    var = torch.clamp_min(h.square().sum(dim=(2, 3), keepdim=True) / hw
                          - mu.square(), 0.0)
    y = (h - mu) * torch.rsqrt(var + eps)
    if order == "norm_act":
        y = f(y)
    return y.to(x.dtype)


def _check_kernel_input(name: str, x: torch.Tensor, act: str,
                        order: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32/bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(
            f"{name} kernel takes a non-empty contiguous NCHW tensor, got "
            f"shape {tuple(x.shape)} strides {x.stride()}")
    if act not in _ACT_CODES or order not in ORDERS:
        raise ValueError(f"unknown activation/order {act}/{order}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"{name} kernel is not differentiable itself; call "
                           "instance_norm_act for the op with its gradient")


def _launch_in_act(entry: str, x: torch.Tensor, act: str, order: str,
                   eps: float) -> torch.Tensor:
    """One launch of an IN+act kernel (C entry point `entry`) on x's device
    and that device's current stream; returns y. Enters the device's
    context only when x is not on the current device."""
    _check_kernel_input(entry[4:], x, act, order)
    n, c, h, w = x.shape
    fn = getattr(kernels.load(), entry)
    y = torch.empty_like(x)
    args = (x.data_ptr(), y.data_ptr(), n * c, h * w, DTYPE_CODES[x.dtype],
            _ACT_CODES[act], int(order == "act_norm"), float(eps))
    if x.device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, entry[4:])
    return y


def in_act_cuda(x: torch.Tensor, act: str, order: str,
                eps: float = EPS) -> torch.Tensor:
    """Launch K1, the IN+act kernel with the centered variance
    (``fused_reference``), on a contiguous NCHW CUDA tensor (float32 or
    bfloat16). Not differentiable itself: raises under autograd."""
    y = _launch_in_act("vct_in_act", x, act, order, eps)
    in_act_cuda.launches += 1
    return y


in_act_cuda.launches = 0


def in_act_tiled_cuda(x: torch.Tensor, act: str, order: str,
                      eps: float = EPS) -> torch.Tensor:
    """Launch K2, the IN+act kernel with the single-pass variance
    (``tiled_reference``), on a contiguous NCHW CUDA tensor (float32 or
    bfloat16). Not differentiable itself: raises under autograd."""
    y = _launch_in_act("vct_in_act_tiled", x, act, order, eps)
    in_act_tiled_cuda.launches += 1
    return y


in_act_tiled_cuda.launches = 0

PLANE_REGIMES = ("warp", "block", "cluster", "stream")


def plane_plan(hw: int, dtype: torch.dtype, vector_ok: bool = True) -> dict:
    """How both IN kernels take planes of `hw` elements of `dtype`
    (``csrc/in_plane.cuh``): the regime (a warp, a CTA or a cluster of CTAs
    holding the plane on chip, or a cluster looping over it), the elements
    per load (16-byte vectors when `vector_ok`: x and y 16-byte aligned and
    hw a multiple of the vector), the elements a thread holds and the CTAs
    per plane. Asks the built library, so it needs the card's toolchain."""
    out = (ctypes.c_int * 4)()
    rc = kernels.load().vct_in_plane_plan(hw, DTYPE_CODES[dtype],
                                          int(vector_ok), out)
    if rc != 0:
        raise ValueError(f"no plane plan for hw={hw}, {dtype}")
    return {"regime": PLANE_REGIMES[out[0]], "vec": out[1], "elems": out[2],
            "cluster": out[3]}


class _InActFused(torch.autograd.Function):
    """The kernel sites: kernel forward (plain off the card), saves x."""

    @staticmethod
    def forward(ctx, x, act, order, eps):
        ctx.save_for_backward(x)
        ctx.cfg = (act, order, eps)
        if x.device.type == "cuda":
            return in_act_cuda(x.contiguous(), act, order, eps)
        return fused_reference(x, act, order, eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return fused_backward(x, g, *ctx.cfg), None, None, None


class _InActTiled(torch.autograd.Function):
    """The tiled configuration's sites: the tiled kernel forward (plain
    off the card; ``fused_reference`` where JAX's tile does not divide H*W),
    saves x."""

    @staticmethod
    def forward(ctx, x, act, order, eps):
        ctx.save_for_backward(x)
        ctx.cfg = (act, order, eps)
        if not tiles_fit(x.shape):
            return fused_reference(x, act, order, eps)
        if x.device.type == "cuda":
            return in_act_tiled_cuda(x.contiguous(), act, order, eps)
        return tiled_reference(x, act, order, eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return fused_backward(x, g, *ctx.cfg), None, None, None


class _InActPlain(torch.autograd.Function):
    """The big slabs: plain forward, saves (x, mean, rsqrt)."""

    @staticmethod
    def forward(ctx, x, act, order, eps):
        y, mu, r = _fused_with_stats(x, act, order, eps)
        ctx.save_for_backward(x, mu, r)
        ctx.cfg = (act, order)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mu, r = ctx.saved_tensors
        return (fused_backward_from_stats(x, mu, r, g, *ctx.cfg), None, None,
                None)


def instance_norm_act(x: torch.Tensor, *, act: str = "relu",
                      order: str = "norm_act", eps: float = EPS,
                      mode: str = "auto") -> torch.Tensor:
    """Fused InstanceNorm+activation of an NCHW tensor, in either order,
    differentiable; `mode` picks the path (module docstring)."""
    if act not in ACTS:
        raise NotImplementedError(f"Activation not implemented: {act}")
    if order not in ORDERS:
        raise ValueError(f"unknown order {order}")
    if mode not in MODES:
        raise ValueError(f"unknown instance norm mode {mode}")
    if mode == "tiled":
        if tiles_fit(x.shape):
            kernels.note_site("in_act_tiled", x.shape, x.dtype, act=act,
                              order=order)
        return _InActTiled.apply(x, act, order, eps)
    if mode == "auto" and slab_fits(x.shape):
        kernels.note_site("in_act", x.shape, x.dtype, act=act, order=order)
        return _InActFused.apply(x, act, order, eps)
    return _InActPlain.apply(x, act, order, eps)
