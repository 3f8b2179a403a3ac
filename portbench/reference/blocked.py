"""A family's training step with the generator step computed in blocks of
samples, for batches whose float32 activations do not fit the card at once.

Each block's mean losses are scaled by its share of the batch and their
gradients summed, which is the whole batch's gradient (every loss term is a
mean over equal per-sample parts); the step's metrics are the blocks' terms
summed by the same shares. What the discriminator step keeps (the detached
fakes) is joined over the blocks in batch order, and that step runs on the
whole batch. ``around(block, lo, hi)``, where given, is a context each
block's generator losses and gradient are computed in (the data-parallel
cell's noise and spectral state). Adam updates each group once, and skips
it where the loss is not finite, as ``steps.Family.step`` does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch


def _join(keeps: List):
    """The blocks' kept tensors (each a tensor or a tuple of them) joined
    along the batch."""
    first = keeps[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(keeps)
    return tuple(_join([k[i] for k in keeps]) for i in range(len(first)))


def step(fam, x: torch.Tensor, y: torch.Tensor,
         generator: Optional[torch.Generator], block: int,
         around: Optional[Callable] = None
         ) -> Tuple[Dict[str, float], List[torch.Tensor], List[torch.Tensor]]:
    """``fam.step(x, y, generator)`` with the generator step in blocks of
    `block` samples."""
    n = len(x)
    parts: Dict[str, torch.Tensor] = {}
    g_loss = 0.0
    g_grads, keeps = None, []
    for b, lo in enumerate(range(0, n, block)):
        hi = min(lo + block, n)
        share = (hi - lo) / n
        mine: Dict[str, torch.Tensor] = {}
        with (around(b, lo, hi) if around else contextlib.nullcontext()):
            loss, keep = fam.generator_loss(x[lo:hi], y[lo:hi], generator,
                                            mine)
            grads = torch.autograd.grad(loss * share, fam.gen_params)
        g_grads = (list(grads) if g_grads is None
                   else [a + g for a, g in zip(g_grads, grads)])
        g_loss = g_loss + share * loss.detach()
        for k, v in mine.items():
            parts[k] = parts.get(k, 0.0) + share * v.detach()
        keeps.append(keep)
        del loss, grads, keep, mine
    fam._update(fam.opts[0], g_loss, fam.gen_params, g_grads)
    parts["G_loss"] = g_loss
    d_grads = ()
    if fam.disc_params:
        d_loss = fam.discriminator_loss(x, y, _join(keeps), parts)
        d_grads = torch.autograd.grad(d_loss, fam.disc_params)
        fam._update(fam.opts[1], d_loss, fam.disc_params, d_grads)
        parts["D_loss"] = d_loss
    return ({k: float(v.detach()) for k, v in parts.items()}, g_grads,
            list(d_grads))


class _Torch:
    """``torch`` as the reference's nets see it inside a block, with its
    ``randn`` replaced."""

    def __init__(self, randn: Callable):
        self.randn = randn

    def __getattr__(self, name: str):
        return getattr(torch, name)


class DataParallel:
    """``step``'s `around` for a family with variational generators and
    spectrally normalised discriminators (``nets.VAE``,
    ``nets.Discriminator``) whose blocks stand for the ranks of a
    data-parallel step over a batch of `n`. The reference's own networks
    run; only two things change inside a block. Each variational pass's
    one noise draw (``nets``' ``torch.randn``) draws the whole batch's
    noise in the first block, in pass order, and every block takes its
    rows of it. Each discriminator call makes its one power iteration in
    the first block, and the other blocks read the vectors that call left
    (the iteration does not read the data)."""

    def __init__(self, fam, n: int):
        from portbench.reference.nets import Discriminator

        self.n = n
        self.discs = [m for m in fam.nets.modules()
                      if isinstance(m, Discriminator)]
        self.noise: List[torch.Tensor] = []
        self.spectral: List = []

    @contextlib.contextmanager
    def __call__(self, block: int, lo: int, hi: int):
        from portbench.reference import nets

        calls = {"pass": 0, "disc": 0}

        def randn(shape, generator=None, device=None, dtype=None):
            i = calls["pass"]
            calls["pass"] += 1
            if block == 0:
                self.noise.append(torch.randn(
                    (self.n, *shape[1:]), generator=generator,
                    device=device, dtype=dtype))
            return self.noise[i][lo:hi]

        def judge(d, x, update: bool = True):
            i = calls["disc"]
            calls["disc"] += 1
            if block == 0:
                out = type(d).forward(d, x, update)
                self.spectral.append(d.spectral_state())
                return out
            d.set_spectral_state(self.spectral[i])
            return type(d).forward(d, x, False)

        for d in self.discs:
            d.forward = lambda x, update=True, _d=d: judge(_d, x, update)
        nets.torch = _Torch(randn)
        try:
            yield
        finally:
            nets.torch = torch
            for d in self.discs:
                del d.forward
