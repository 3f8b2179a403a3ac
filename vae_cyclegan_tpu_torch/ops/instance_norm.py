"""Fused InstanceNorm + activation, the reference's per-layer pattern.

Semantics match ``torch.nn.InstanceNorm2d`` defaults: biased variance,
eps=1e-5, no affine parameters, statistics in float32. Two orders:

  * ``norm_act``: InstanceNorm then activation (CaSb)
  * ``act_norm``: activation then InstanceNorm (D/R/U blocks)

Dispatch follows the JAX package's rule (``vae_cyclegan_tpu/ops/
instance_norm.py::instance_norm_act``): a slab whose per-sample f32 size
H*W*C*4 is at most 1 MB takes the kernel (``csrc/in_act.cu``, the port of
``_pallas_in_act``); larger slabs take the plain version, as JAX sends them
to XLA. On the serving path the kernel runs at the five 16x16x1024 sites.
A CUDA tensor that the rule selects launches the kernel or raises; CPU and
``meta`` tensors take the plain version.
"""

from __future__ import annotations

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
# codes of csrc/in_act.cu and csrc/common.cuh
_ACT_CODES = {"relu": 0, "leaky_relu": 1, "tanh": 2, "sigmoid": 3,
              "identity": 4}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Plain InstanceNorm of an NCHW tensor (stats per (n, c) in f32,
    centered biased variance), returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mu).square().mean(dim=(2, 3), keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def fused_reference(x: torch.Tensor, act: str, order: str,
                    eps: float = EPS) -> torch.Tensor:
    """Plain version of the fused op (``_fused_reference`` of the JAX
    package, rounding to x's dtype between the activation and the norm
    the same way)."""
    f = ACTS[act]
    if order == "norm_act":
        return f(instance_norm(x, eps).float()).to(x.dtype)
    if order == "act_norm":
        return instance_norm(f(x.float()).to(x.dtype), eps)
    raise ValueError(f"unknown order {order}")


def slab_fits(shape) -> bool:
    """The kernel rule: one sample's (C, H, W) slab is at most 1 MB in f32
    (``_slab_fits_vmem`` of the JAX package)."""
    _, c, h, w = shape
    return h * w * c * 4 <= SLAB_BYTES


def in_act_cuda(x: torch.Tensor, act: str, order: str,
                eps: float = EPS) -> torch.Tensor:
    """Launch the IN+act kernel on a contiguous NCHW CUDA tensor (float32 or
    bfloat16). Forward only: raises under autograd."""
    if x.device.type != "cuda":
        raise ValueError(f"in_act kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"in_act kernel takes float32/bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(
            f"in_act kernel takes a non-empty contiguous NCHW tensor, got "
            f"shape {tuple(x.shape)} strides {x.stride()}")
    if act not in _ACT_CODES or order not in ORDERS:
        raise ValueError(f"unknown activation/order {act}/{order}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("in_act kernel is forward-only; run under "
                           "torch.no_grad() (its backward comes with training)")
    n, c, h, w = x.shape
    lib = kernels.load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vct_in_act(x.data_ptr(), y.data_ptr(), n * c, h * w,
                            DTYPE_CODES[x.dtype], _ACT_CODES[act],
                            int(order == "act_norm"), float(eps), stream)
    kernels.check(rc, "in_act")
    in_act_cuda.launches += 1
    return y


in_act_cuda.launches = 0


def instance_norm_act(x: torch.Tensor, *, act: str = "relu",
                      order: str = "norm_act",
                      eps: float = EPS) -> torch.Tensor:
    """Fused InstanceNorm+activation of an NCHW tensor, in either order."""
    if act not in ACTS:
        raise NotImplementedError(f"Activation not implemented: {act}")
    if order not in ORDERS:
        raise ValueError(f"unknown order {order}")
    if slab_fits(x.shape):
        kernels.note_site("in_act", x.shape, x.dtype, act=act, order=order)
        if x.device.type == "cuda":
            return in_act_cuda(x.contiguous(), act, order, eps)
    return fused_reference(x, act, order, eps)
