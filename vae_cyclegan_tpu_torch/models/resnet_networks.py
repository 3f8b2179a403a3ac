"""The published CycleGAN's networks, NCHW: ``ResnetGenerator``
(``--netG resnet_9blocks``) and the 70x70 PatchGAN ``NLayerDiscriminator``
(``--netD basic``, three layers), with instance norm and no dropout, as
``models/networks.py`` of ``junyanz/pytorch-CycleGAN-and-pix2pix`` builds
them (Zhu, Park, Isola and Efros, ICCV 2017, arXiv:1703.10593).

Shapes at image_size=256, ngf = ndf = 64:

  ResnetGenerator:     (B, 3, 256, 256) -> (B, 3, 256, 256) in [-1, 1]
                       (its trunk: nine residual blocks at (B, 256, 64, 64))
  NLayerDiscriminator: (B, 3, 256, 256) -> (B, 1, 30, 30), one score a
                       70x70 patch

Submodule indices follow the published ``nn.Sequential`` lists, so the
``state_dict`` keys are the published ones (``model.1.weight``,
``model.10.conv_block.5.bias``, ``model.11.weight``) and a published
``latest_net_G_A.pth`` has the same keys and shapes. Where the published
list holds a ``ReflectionPad2d`` or an activation, this one holds a
parameterless ``Folded`` slot: the pad is the next conv's
(``blocks.ReflectConv``, whose stride-1 convs go through the starved-conv
dispatcher, so the 7x7 head and tail take K3 / K4 where ``supported`` says
so and the 256-channel trunk convs the plain reflect conv), the activation
the norm's before it (``instance_norm_act``, order ``norm_act``). The
stride-2 and transposed convs and every conv of the discriminator are
zero-padded ``F.conv2d`` / ``F.conv_transpose2d`` (``ZeroConv``).
Parameters are float32; convs run in the network's ``dtype`` (the input's
when None), the bias added by the conv in that dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vae_cyclegan_tpu_torch.models.blocks import ReflectConv
from vae_cyclegan_tpu_torch.ops import instance_norm_act
from vae_cyclegan_tpu_torch.ops.instance_norm import ACTS

#: the published init's standard deviation (``init_weights``, normal, gain
#: 0.02)
INIT_STD = 0.02


class Folded(nn.Identity):
    """A published layer that a neighbouring module computes (a reflection
    pad, an activation after a norm): no parameters, x passes through."""


class NormAct(nn.Module):
    """InstanceNorm (no affine, eps 1e-5) then the activation, by the
    configuration's InstanceNorm mode."""

    def __init__(self, act: str, instance_norm: str = "auto"):
        super().__init__()
        self.act, self.instance_norm = act, instance_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm_act(x, act=self.act, order="norm_act",
                                 mode=self.instance_norm)


class Act(nn.Module):
    """An activation alone, computed in float32 and returned in x's
    dtype."""

    def __init__(self, act: str):
        super().__init__()
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ACTS[self.act](x.float()).to(x.dtype)


class ZeroConv(nn.Module):
    """A zero-padded conv with a bias: ``F.conv2d``, or with `transposed`
    ``F.conv_transpose2d`` (weight (cin, cout, k, k), `output_padding`)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 padding: int, transposed: bool = False,
                 output_padding: int = 0,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.transposed, self.output_padding = transposed, output_padding
        self.dtype = dtype
        shape = ((cin, cout) if transposed else (cout, cin)) + (
            kernel_size, kernel_size)
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x, w, b = x.to(dtype), self.weight.to(dtype), self.bias.to(dtype)
        if self.transposed:
            return F.conv_transpose2d(x, w, b, self.stride, self.padding,
                                      self.output_padding)
        return F.conv2d(x, w, b, self.stride, self.padding)


class ResnetBlock(nn.Module):
    """x + IN(conv3(rpad1(ReLU(IN(conv3(rpad1(x))))))); nothing follows the
    add."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None,
                 device=None, instance_norm: str = "auto"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv_block = nn.Sequential(
            Folded(), ReflectConv(dim, dim, 3, 1, 1, **kw),
            NormAct("relu", instance_norm), Folded(),
            Folded(), ReflectConv(dim, dim, 3, 1, 1, **kw),
            NormAct("identity", instance_norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """rpad3 -> conv7 3->ngf -> IN -> ReLU; two conv3 stride-2 zero-pad-1
    down steps (ngf->2ngf->4ngf), each IN -> ReLU; `n_blocks` residual
    blocks at 4ngf; two ConvTranspose2d 3x3 stride-2 up steps (4ngf->2ngf
    ->ngf), each IN -> ReLU; rpad3 -> conv7 ngf->3 -> tanh. Takes and
    returns images in [-1, 1]."""

    def __init__(self, ngf: int = 64, n_blocks: int = 9,
                 dtype: Optional[torch.dtype] = None, device=None,
                 instance_norm: str = "auto"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        layers = [Folded(), ReflectConv(3, ngf, 7, 1, 3, **kw),
                  NormAct("relu", instance_norm), Folded()]
        for mult in (1, 2):
            layers += [ZeroConv(ngf * mult, ngf * mult * 2, 3, 2, 1, **kw),
                       NormAct("relu", instance_norm), Folded()]
        layers += [ResnetBlock(ngf * 4, instance_norm=instance_norm, **kw)
                   for _ in range(n_blocks)]
        for mult in (4, 2):
            layers += [ZeroConv(ngf * mult, ngf * mult // 2, 3, 2, 1,
                                transposed=True, output_padding=1, **kw),
                       NormAct("relu", instance_norm), Folded()]
        layers += [Folded(), ReflectConv(ngf, 3, 7, 1, 3, **kw), Act("tanh")]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class NLayerDiscriminator(nn.Module):
    """conv4 s2 3->ndf -> LeakyReLU(0.2); conv4 s2 ndf->2ndf->4ndf, each IN
    -> LeakyReLU; conv4 s1 4ndf->8ndf -> IN -> LeakyReLU; conv4 s1 8ndf->1;
    every conv zero-padded by 1: a (B, 1, H/8 - 2, W/8 - 2) map of patch
    scores."""

    def __init__(self, ndf: int = 64, dtype: Optional[torch.dtype] = None,
                 device=None, instance_norm: str = "auto"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        layers = [ZeroConv(3, ndf, 4, 2, 1, **kw), Act("leaky_relu")]
        for cin, cout, stride in ((ndf, ndf * 2, 2), (ndf * 2, ndf * 4, 2),
                                  (ndf * 4, ndf * 8, 1)):
            layers += [ZeroConv(cin, cout, 4, stride, 1, **kw),
                       NormAct("leaky_relu", instance_norm), Folded()]
        layers += [ZeroConv(ndf * 8, 1, 4, 1, 1, **kw)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


@torch.no_grad()
def init_published(net: nn.Module, generator: torch.Generator) -> None:
    """The published ``init_weights(net, "normal", 0.02)``: every conv
    weight N(0, 0.02), every bias zero, drawn on the CPU from `generator` in
    module order."""
    for module in net.modules():
        if isinstance(module, (ReflectConv, ZeroConv)):
            module.weight.copy_(torch.randn(
                module.weight.shape, generator=generator) * INIT_STD)
            module.bias.zero_()
