"""The training step and the generator forward of a family, plain PyTorch
in float32 (``Networks.py``'s training steps, the LSGAN / L1 / KL losses
with the published weights). Each architecture's losses live in
``families/<architecture>.py``, found by name.

A step is the alternating pair: the generator update on the generator
losses (the discriminators in its graph, taking no gradient), then the
discriminator update on the detached fakes of the pre-update generators,
each with Adam (lr 2e-4, betas 0.5 / 0.999, eps 1e-8) and skipped whole
where its loss is not finite. The noise of every variational pass is drawn
from the one generator handed in, in call order.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from portbench.reference.nets import F32, VAE, Discriminator, Precision


def l1(a, b):
    return (a - b).abs().mean()


def mse(a, target: float):
    return (a - target).square().mean()


def kl(mu, logvar):
    lv = logvar.clamp(-10.0, 10.0)
    return -0.5 * (1.0 + lv - mu.square() - lv.exp()).mean()


class Family:
    """The networks (an ``nn.ModuleDict`` keyed as the published
    checkpoint: G, F, DX, DY or G, D), the two parameter groups in the
    published optimizer order and their Adams."""

    gen_keys: Tuple[str, ...] = ()
    disc_keys: Tuple[str, ...] = ()

    def __init__(self, cfg: dict, prec: Precision = F32, device="cpu"):
        self.cfg = cfg
        w, latent = cfg["base_width"], cfg["latent_dim"]
        fk = cfg["image_size"] // 16
        nets = {k: VAE(w, latent, prec) for k in self.gen_keys}
        nets.update({k: Discriminator(w, fk, prec) for k in self.disc_keys})
        self.nets = nn.ModuleDict(nets).to(device)
        self.lam = cfg["losses"]
        self.gen_params = [p for k in self.gen_keys
                           for p in self.nets[k].parameters()]
        self.disc_params = [p for k in self.disc_keys
                            for p in self.nets[k].parameters()]
        self.opts = None

    def load(self, weights: Dict[str, torch.Tensor]) -> None:
        self.nets.load_state_dict(weights)
        adam = self.cfg["adam"]
        kw = dict(lr=adam["lr"], betas=tuple(adam["betas"]), eps=adam["eps"])
        self.opts = tuple(torch.optim.Adam(group, **kw) for group in
                          (self.gen_params, self.disc_params) if group)

    @staticmethod
    def _update(opt, loss, params, grads) -> None:
        if bool(torch.isfinite(loss)):
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
        for p in params:
            p.grad = None

    def step(self, x: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator]
             ) -> Tuple[Dict[str, float], List[torch.Tensor],
                        List[torch.Tensor]]:
        """One training step on NCHW f32 batches in [0, 1]: (the step's
        metrics under the program's names, G_loss and, with a
        discriminator, D_loss among them; the generator's and the
        discriminator's gradients as Adam gets them)."""
        parts: Dict[str, torch.Tensor] = {}
        g_loss, keep = self.generator_loss(x, y, generator, parts)
        g_grads = torch.autograd.grad(g_loss, self.gen_params)
        self._update(self.opts[0], g_loss, self.gen_params, g_grads)
        parts["G_loss"] = g_loss
        d_grads = ()
        if self.disc_params:
            d_loss = self.discriminator_loss(x, y, keep, parts)
            d_grads = torch.autograd.grad(d_loss, self.disc_params)
            self._update(self.opts[1], d_loss, self.disc_params, d_grads)
            parts["D_loss"] = d_loss
        return ({k: float(v.detach()) for k, v in parts.items()},
                list(g_grads), list(d_grads))

    def model_flops_pass(self, x, y, generator) -> None:
        """The forward and backward passes of one step without the updates
        (what a FLOP count of the step measures)."""
        g_loss, keep = self.generator_loss(x, y, generator, {})
        torch.autograd.grad(g_loss, self.gen_params)
        if self.disc_params:
            d_loss = self.discriminator_loss(x, y, keep, {})
            torch.autograd.grad(d_loss, self.disc_params)

    def generator_loss(self, x, y, generator, parts):
        """(G_loss, what the discriminator step keeps); the loss's terms
        go into `parts` under the program's metric names."""
        raise NotImplementedError

    def discriminator_loss(self, x, y, keep, parts):
        raise NotImplementedError

    @torch.no_grad()
    def generate(self, x: torch.Tensor, generator) -> torch.Tensor:
        """G(x), NCHW, unclipped."""
        return self.nets["G"](x, generator)[0]


def family(cfg: dict, prec: Precision = F32, device="cpu") -> Family:
    """The reference of ``cfg["architecture"]``, from
    ``families/<architecture>.py``."""
    module = importlib.import_module(
        f"portbench.reference.families.{cfg['architecture']}")
    return module.FAMILY(cfg, prec, device)
