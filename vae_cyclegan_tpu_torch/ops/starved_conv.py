"""Reflect-padded SAME convolution for the big-spatial, low-channel shapes.

Dispatch follows the JAX package exactly (``vae_cyclegan_tpu/ops/
starved_conv.py``): a stride-1, odd-k conv whose shape passes ``supported``
(``_supported``) and whose forward the kernel wins (``fwd_wins``,
``_fwd_wins``: cin >= 8) takes the kernel (``csrc/starved_conv.cu``, the
port of ``_conv_call`` in reflect mode). On the serving path that is the
decoder's U4 conv (k3, 32->64) and tail conv (k7, 64->3) at 256x256; the
encoder head (k7, 3->64) is supported but stays on the plain conv, as JAX
keeps its forward on XLA. Every other conv takes the plain version,
``reflect_conv``. A CUDA tensor that the rule selects launches the kernel
or raises; CPU and ``meta`` tensors take the plain version.

The JAX package's channel-major entry points and ``VCT_*`` knobs steer TPU
layouts and tiles; they have no counterpart here.
"""

from __future__ import annotations

import torch

from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.ops.instance_norm import DTYPE_CODES
from vae_cyclegan_tpu_torch.ops.reflect_conv import reflect_conv

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


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


def reflect_conv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the reflect-SAME conv kernel: contiguous NCHW x and OIHW w on
    the same CUDA device, both float32 or both bfloat16, odd k. No bias.
    Forward only: raises under autograd."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"starved conv kernel needs x and w on one CUDA "
                         f"device, got {x.device} and {w.device}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"starved conv kernel takes float32/bfloat16 x and w "
                        f"of one dtype, got {x.dtype} and {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or not (x.is_contiguous()
                                            and w.is_contiguous()):
        raise ValueError("starved conv kernel takes contiguous NCHW x and "
                         "OIHW w")
    n, cin, h, wd = x.shape
    cout, cin_w, k, k2 = w.shape
    if (cin_w != cin or k != k2 or k % 2 == 0 or k // 2 >= min(h, wd)
            or n == 0 or n > 65535):
        raise ValueError(f"starved conv kernel cannot take x {tuple(x.shape)}"
                         f" with w {tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("starved conv kernel is forward-only; run under "
                           "torch.no_grad() (its backward comes with training)")
    lib = kernels.load()
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vct_reflect_conv(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  n, cin, cout, h, wd, k,
                                  DTYPE_CODES[x.dtype], stream)
    kernels.check(rc, "starved_conv")
    reflect_conv_cuda.launches += 1
    return y


reflect_conv_cuda.launches = 0


def starved_reflect_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reflect-padded SAME conv (stride 1, odd k, NCHW x, OIHW w, no bias),
    dispatching the starved shapes to the kernel and the rest to
    ``reflect_conv``."""
    cout, cin, k, _ = w.shape
    if supported(x.shape, w.shape, x.dtype) and fwd_wins(k, cin, cout):
        kernels.note_site("starved_conv", x.shape, x.dtype, k=k, cin=cin,
                          cout=cout)
        if x.device.type == "cuda":
            return reflect_conv_cuda(x.contiguous(), w.contiguous())
    return reflect_conv(x, w)
