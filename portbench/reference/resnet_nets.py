"""Plain PyTorch networks of the published CycleGAN
(``junyanz/pytorch-CycleGAN-and-pix2pix``, ``models/networks.py``:
``ResnetGenerator`` with nine blocks and the three-layer 70x70
``NLayerDiscriminator``, instance norm, no dropout), in float32.

Every reflection pad is ``F.pad(mode="reflect")``, every InstanceNorm
``F.instance_norm`` (biased variance, eps 1e-5, no affine), every conv
``F.conv2d`` / ``F.conv_transpose2d`` with its bias. Module indices follow
the published ``nn.Sequential`` lists, so the ``state_dict`` keys are the
published ones (``model.1.weight``, ``model.10.conv_block.5.weight``,
``model.11.bias``), which are also the program's.

``Precision`` rounds every tensor the program keeps in bfloat16 to float8
in the control: each conv's operands and result, each InstanceNorm's
activated output, each residual sum and the tanh output. A generator
returns a tuple whose first item is its image, in [-1, 1].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.nets import F32, IN_EPS, LEAKY_SLOPE, Precision


class Pad(nn.Module):
    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return F.pad(x, (self.pad,) * 4, mode="reflect")


class Conv(nn.Module):
    """conv(x, w, stride, zero pad) + b, or the transposed conv."""

    def __init__(self, cin, cout, k, stride=1, pad=0, transposed=False,
                 output_padding=0, prec: Precision = F32):
        super().__init__()
        self.stride, self.pad, self.prec = stride, pad, prec
        self.transposed, self.output_padding = transposed, output_padding
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        q = self.prec.operand
        if self.transposed:
            y = F.conv_transpose2d(q(x), q(self.weight), self.bias,
                                   self.stride, self.pad, self.output_padding)
        else:
            y = F.conv2d(q(x), q(self.weight), self.bias, self.stride,
                         self.pad)
        return q(y)


class NormAct(nn.Module):
    """InstanceNorm, then ReLU / LeakyReLU(0.2) / nothing."""

    def __init__(self, act: str, prec: Precision = F32):
        super().__init__()
        self.act, self.prec = act, prec

    def forward(self, x):
        x = F.instance_norm(x, eps=IN_EPS)
        if self.act == "relu":
            x = F.relu(x)
        elif self.act == "leaky_relu":
            x = F.leaky_relu(x, LEAKY_SLOPE)
        return self.prec.operand(x)


class Act(nn.Module):
    def __init__(self, act: str, prec: Precision = F32):
        super().__init__()
        self.act, self.prec = act, prec

    def forward(self, x):
        x = torch.tanh(x) if self.act == "tanh" else F.leaky_relu(
            x, LEAKY_SLOPE)
        return self.prec.operand(x)


class ResnetBlock(nn.Module):
    def __init__(self, dim, prec: Precision = F32):
        super().__init__()
        self.prec = prec
        self.conv_block = nn.Sequential(
            Pad(1), Conv(dim, dim, 3, prec=prec), NormAct("relu", prec),
            nn.Identity(), Pad(1), Conv(dim, dim, 3, prec=prec),
            NormAct("identity", prec))

    def forward(self, x):
        return self.prec.operand(x + self.conv_block(x))


class ResnetGenerator(nn.Module):
    """(image in [-1, 1],): rpad3, conv7, IN, ReLU; two stride-2 conv3 with
    IN, ReLU; nine residual blocks; two stride-2 transposed conv3 with IN,
    ReLU; rpad3, conv7, tanh."""

    def __init__(self, ngf=64, n_blocks=9, prec: Precision = F32):
        super().__init__()
        layers = [Pad(3), Conv(3, ngf, 7, prec=prec), NormAct("relu", prec),
                  nn.Identity()]
        for mult in (1, 2):
            layers += [Conv(ngf * mult, ngf * mult * 2, 3, 2, 1, prec=prec),
                       NormAct("relu", prec), nn.Identity()]
        layers += [ResnetBlock(ngf * 4, prec) for _ in range(n_blocks)]
        for mult in (4, 2):
            layers += [Conv(ngf * mult, ngf * mult // 2, 3, 2, 1, True, 1,
                            prec=prec), NormAct("relu", prec), nn.Identity()]
        layers += [Pad(3), Conv(ngf, 3, 7, prec=prec), Act("tanh", prec)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return (self.model(x),)


class NLayerDiscriminator(nn.Module):
    """conv4 s2 + LeakyReLU; conv4 s2, conv4 s2, conv4 s1, each IN +
    LeakyReLU; conv4 s1 to one channel; zero pad 1 throughout."""

    def __init__(self, ndf=64, prec: Precision = F32):
        super().__init__()
        layers = [Conv(3, ndf, 4, 2, 1, prec=prec), Act("leaky_relu", prec)]
        for cin, cout, stride in ((ndf, ndf * 2, 2), (ndf * 2, ndf * 4, 2),
                                  (ndf * 4, ndf * 8, 1)):
            layers += [Conv(cin, cout, 4, stride, 1, prec=prec),
                       NormAct("leaky_relu", prec), nn.Identity()]
        layers += [Conv(ndf * 8, 1, 4, 1, 1, prec=prec)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)
