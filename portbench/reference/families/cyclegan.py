"""The published CycleGAN's training step (``models/cycle_gan_model.py`` of
``junyanz/pytorch-CycleGAN-and-pix2pix``) at its defaults: LSGAN, cycle
weights 10, identity 0.5 x 10 on unpaired data, the 50-image history pools.

Images are mapped from [0, 1] to [-1, 1], where every loss is taken. The
pools (``ImagePool``) run the published per-image loop; their decisions
come from a CPU ``torch.Generator`` seeded from the step generator's
``initial_seed()`` at the first step (``torch.rand(1)`` per image that finds
the pool full, ``torch.randint(0, 50, (1,))`` where a swap follows), pool_B
(G_A's fakes) queried before pool_A; without a generator (the FLOP count on
``meta``) the fresh fakes pass through.

At a cell's batch of 24 the float32 generator step would not fit the card
beside what the released program leaves, so it is computed in blocks of
``BLOCK`` samples (``reference/blocked.py``: each block's mean losses scaled
by its share, the gradients summed); the pools get the whole batch's
detached fakes in order, and the discriminator step runs on the whole
batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from portbench.reference import blocked
from portbench.reference.nets import F32
from portbench.reference.resnet_nets import (
    NLayerDiscriminator,
    ResnetGenerator,
)
from portbench.reference.steps import Family, l1, mse

#: the images each history pool holds
POOL_SIZE = 50
#: the samples of one block of the generator step (about 2.8 GB of float32
#: activations a sample at 256x256)
BLOCK = 8


class ImagePool:
    """``util/image_pool.py``, drawing from a ``torch.Generator``."""

    def __init__(self, size: int = POOL_SIZE):
        self.size, self.images = size, []

    def query(self, images: torch.Tensor,
              stream: Optional[torch.Generator]) -> torch.Tensor:
        if stream is None:
            return images
        out = []
        for image in images:
            image = image[None]
            if len(self.images) < self.size:
                self.images.append(image)
                out.append(image)
            elif float(torch.rand(1, generator=stream)) > 0.5:
                j = int(torch.randint(0, self.size, (1,), generator=stream))
                out.append(self.images[j].clone())
                self.images[j] = image
            else:
                out.append(image)
        return torch.cat(out)


class CycleGAN(Family):
    """G_A: A -> B, G_B: B -> A, D_A judging B, D_B judging A. The batch's x
    is A, y is B; metric names as the program's (x the A side)."""

    gen_keys = ("G_A", "G_B")
    disc_keys = ("D_A", "D_B")

    def __init__(self, cfg: dict, prec=F32, device="cpu"):
        self.cfg = cfg
        w = cfg["base_width"]
        nets = {k: ResnetGenerator(w, prec=prec) for k in self.gen_keys}
        nets.update({k: NLayerDiscriminator(w, prec) for k in self.disc_keys})
        self.nets = nn.ModuleDict(nets).to(device)
        self.lam = cfg["losses"]
        self.gen_params = [p for k in self.gen_keys
                           for p in self.nets[k].parameters()]
        self.disc_params = [p for k in self.disc_keys
                            for p in self.nets[k].parameters()]
        self.opts = None
        self.pools = {"A": ImagePool(), "B": ImagePool()}
        self.stream: Optional[torch.Generator] = None

    def step(self, x, y, generator):
        if generator is not None and self.stream is None:
            self.stream = torch.Generator().manual_seed(
                generator.initial_seed())
        return blocked.step(self, x, y, generator, BLOCK)

    def generator_loss(self, x, y, generator, parts):
        G_A, G_B, D_A, D_B = (self.nets[k] for k in
                              ("G_A", "G_B", "D_A", "D_B"))
        a, b = 2.0 * x - 1.0, 2.0 * y - 1.0
        fake_B = G_A(a)[0]
        rec_A = G_B(fake_B)[0]
        fake_A = G_B(b)[0]
        rec_B = G_A(fake_A)[0]
        idt_A = G_A(b)[0]
        idt_B = G_B(a)[0]
        parts.update(
            loss_gan_g_y_fake=mse(D_A(fake_B), 1.0),
            loss_gan_g_x_fake=mse(D_B(fake_A), 1.0),
            loss_cycle=l1(rec_A, a) + l1(rec_B, b),
            loss_identity=l1(idt_A, b) + l1(idt_B, a))
        lam = self.lam
        loss = (lam["gan"] * (parts["loss_gan_g_y_fake"]
                              + parts["loss_gan_g_x_fake"])
                + lam["cycle"] * parts["loss_cycle"]
                + lam["identity"] * parts["loss_identity"])
        return loss, (fake_B.detach(), fake_A.detach())

    def discriminator_loss(self, x, y, keep, parts):
        fake_B, fake_A = keep
        D_A, D_B = self.nets["D_A"], self.nets["D_B"]
        a, b = 2.0 * x - 1.0, 2.0 * y - 1.0
        seen_B = self.pools["B"].query(fake_B, self.stream)
        seen_A = self.pools["A"].query(fake_A, self.stream)
        pred = {"y_real": D_A(b), "y_fake": D_A(seen_B),
                "x_real": D_B(a), "x_fake": D_B(seen_A)}
        for k, p in pred.items():
            parts[f"D_loss_{k}"] = mse(p, 1.0 if k.endswith("real") else 0.0)
            parts[f"d_{k}_mean"] = p.mean()
        return (0.5 * (parts["D_loss_y_real"] + parts["D_loss_y_fake"])
                + 0.5 * (parts["D_loss_x_real"] + parts["D_loss_x_fake"]))

    @torch.no_grad()
    def generate(self, x: torch.Tensor, generator) -> torch.Tensor:
        """G_A(2x - 1) mapped back to [0, 1], NCHW, unclipped."""
        return (self.nets["G_A"](2.0 * x - 1.0)[0] + 1.0) * 0.5


FAMILY = CycleGAN
