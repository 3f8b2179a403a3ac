"""The model path's hand kernels (K1-K4) as PyTorch custom operators.

Each kernel is registered with ``torch.library.custom_op`` in the ``vct``
namespace, so that ``torch.export`` records it as one node of the graph
(its ``register_fake`` gives the output's shape, dtype and device) and a
program that runs on the card launches the hand kernel:

  ``vct::in_act(x, act, order, eps)``        K1, ``csrc/in_act.cu``
  ``vct::in_act_tiled(x, act, order, eps)``  K2, ``csrc/in_act_tiled.cu``
  ``vct::starved_conv(x, w, mode)``          K3, ``csrc/starved_conv.cu``,
                                             mode "reflect", "zero_same" or
                                             "zero"
  ``vct::starved_dw(x, g, k)``               K4, ``csrc/starved_dw.cu``

The operator's dispatch picks the implementation by the device of its
tensors: on a CUDA tensor the kernel's wrapper (``ops.instance_norm.
in_act_cuda``, ``in_act_tiled_cuda``, ``ops.starved_conv.reflect_conv_cuda``
/ ``zero_conv_cuda``, ``dw_cuda``), which launches the kernel or raises and
counts its launches; on a CPU tensor the kernel's plain version
(``fused_reference``, ``tiled_reference``, ``reflect_conv`` /
``zero_conv``, ``dw_reference``); on the ``meta`` device the fake. The
dispatch rules that decide whether a site takes a kernel at all
(``slab_fits``, ``tiles_fit``, ``supported``, ``fwd_wins``) and
``kernels.note_site`` stay in Python, ahead of the operator, in the
modules that own them.

The operators are not differentiable themselves: the autograd Functions of
``ops.instance_norm`` and ``ops.starved_conv`` call them in their forward
and backward. Importing this module registers the four operators (the ops
modules import it); load an exported program only after that.
"""

from __future__ import annotations

import torch
from torch import Tensor

_LIB = "vct"


def _empty_like(x: Tensor) -> Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


# K1 -----------------------------------------------------------------------


@torch.library.custom_op(f"{_LIB}::in_act", mutates_args=(),
                         device_types="cpu")
def in_act(x: Tensor, act: str, order: str, eps: float) -> Tensor:
    from vae_cyclegan_tpu_torch.ops.instance_norm import fused_reference
    return fused_reference(x, act, order, eps)


@in_act.register_kernel("cuda")
def _in_act_cuda(x: Tensor, act: str, order: str, eps: float) -> Tensor:
    from vae_cyclegan_tpu_torch.ops.instance_norm import in_act_cuda
    return in_act_cuda(x.contiguous(), act, order, eps)


@in_act.register_fake
def _in_act_fake(x: Tensor, act: str, order: str, eps: float) -> Tensor:
    return _empty_like(x)


# K2 -----------------------------------------------------------------------


@torch.library.custom_op(f"{_LIB}::in_act_tiled", mutates_args=(),
                         device_types="cpu")
def in_act_tiled(x: Tensor, act: str, order: str, eps: float) -> Tensor:
    from vae_cyclegan_tpu_torch.ops.instance_norm import tiled_reference
    return tiled_reference(x, act, order, eps)


@in_act_tiled.register_kernel("cuda")
def _in_act_tiled_cuda(x: Tensor, act: str, order: str,
                       eps: float) -> Tensor:
    from vae_cyclegan_tpu_torch.ops.instance_norm import in_act_tiled_cuda
    return in_act_tiled_cuda(x.contiguous(), act, order, eps)


@in_act_tiled.register_fake
def _in_act_tiled_fake(x: Tensor, act: str, order: str,
                       eps: float) -> Tensor:
    return _empty_like(x)


# K3 -----------------------------------------------------------------------


@torch.library.custom_op(f"{_LIB}::starved_conv", mutates_args=(),
                         device_types="cpu")
def starved_conv(x: Tensor, w: Tensor, mode: str) -> Tensor:
    from vae_cyclegan_tpu_torch.ops.starved_conv import reflect_conv, zero_conv
    if mode == "reflect":
        return reflect_conv(x, w)
    return zero_conv(x, w, mode)


@starved_conv.register_kernel("cuda")
def _starved_conv_cuda(x: Tensor, w: Tensor, mode: str) -> Tensor:
    from vae_cyclegan_tpu_torch.ops.starved_conv import (
        reflect_conv_cuda,
        zero_conv_cuda,
    )
    if mode == "reflect":
        return reflect_conv_cuda(x.contiguous(), w.contiguous())
    return zero_conv_cuda(x.contiguous(), w.contiguous(), mode)


@starved_conv.register_fake
def _starved_conv_fake(x: Tensor, w: Tensor, mode: str) -> Tensor:
    grow = w.shape[-1] - 1 if mode == "zero" else 0
    n, _, h, wd = x.shape
    return x.new_empty((n, w.shape[0], h + grow, wd + grow))


# K4 -----------------------------------------------------------------------


@torch.library.custom_op(f"{_LIB}::starved_dw", mutates_args=(),
                         device_types="cpu")
def starved_dw(x: Tensor, g: Tensor, k: int) -> Tensor:
    from vae_cyclegan_tpu_torch.ops.starved_conv import dw_reference
    return dw_reference(x, g, k)


@starved_dw.register_kernel("cuda")
def _starved_dw_cuda(x: Tensor, g: Tensor, k: int) -> Tensor:
    from vae_cyclegan_tpu_torch.ops.starved_conv import dw_cuda
    return dw_cuda(x.contiguous(), g.contiguous(), k)


@starved_dw.register_fake
def _starved_dw_fake(x: Tensor, g: Tensor, k: int) -> Tensor:
    return x.new_empty((g.shape[1], x.shape[1], k, k), dtype=torch.float32)
