"""CycleGAN as published (``models/cycle_gan_model.py`` of
``junyanz/pytorch-CycleGAN-and-pix2pix``; Zhu et al., ICCV 2017): two
ResNet-9 generators G_A (A -> B) and G_B (B -> A), two 70x70 PatchGAN
discriminators D_A (judges domain B) and D_B (judges domain A), LSGAN, and
a 50-image history pool per discriminator (``models/image_pool.py``).

The batch's x is domain A and y domain B, in [0, 1]; the networks see them
mapped to [-1, 1], where every loss is taken. Per training step, with a and
b the mapped batches:

  G step (six generator passes, two discriminator passes, D taking no
  gradient): L_G = MSE(D_A(G_A(a)), 1) + MSE(D_B(G_B(b)), 1)
  + lambda_cycle (|G_B(G_A(a)) - a| + |G_A(G_B(b)) - b|)
  + lambda_identity (|G_A(b) - b| + |G_B(a) - a|), each term a mean (the
  identity terms on unpaired data too, as published);
  D step, on the fakes of the generators before their update, through the
  pools (pool_B of G_A's fakes queried first, then pool_A):
  L_D = 1/2 [MSE(D_A(b), 1) + MSE(D_A(pool_B(G_A(a))), 0)]
  + 1/2 [MSE(D_B(a), 1) + MSE(D_B(pool_A(G_B(b))), 0)].

One Adam covers G_A + G_B, one D_A + D_B. The metric names follow the
cycle-GAN tasks' (``tasks/cyclegan.py``) with x the A side and y the B
side: ``D_loss_y_*`` are D_A's terms, ``D_loss_x_*`` D_B's,
``loss_gan_g_y_fake`` is MSE(D_A(G_A(a)), 1).

The pools' decisions are drawn from a CPU ``torch.Generator`` seeded, at
the first step that hands in a generator, from that generator's
``initial_seed()`` (the engine's noise seed); a step without a generator
passes the fresh fakes through. The task runs on one device: data and
spatial parallelism are refused (``CycleGANTask.refuse_parallel``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from vae_cyclegan_tpu_torch import losses
from vae_cyclegan_tpu_torch.models.image_pool import ImagePool
from vae_cyclegan_tpu_torch.models.resnet_networks import (
    NLayerDiscriminator,
    ResnetGenerator,
    init_published,
)
from vae_cyclegan_tpu_torch.models.tasks.base import Task
from vae_cyclegan_tpu_torch.parallel import dp, spatial

#: the images each history pool holds (``--pool_size``)
POOL_SIZE = 50


NO_SPATIAL = ("cyclegan has no spatial parallelism: a PatchGAN split across "
              "ranks (halo rows for its zero-padded and transposed convs) is "
              "not built")
NO_DATA = ("cyclegan has no data parallelism: a rank's share of the two "
           "history pools is not built")


def _lsgan(pred: torch.Tensor, target: float) -> torch.Tensor:
    """The published ``GANLoss("lsgan")``: MSE of the score map against a
    constant target, in float32."""
    return (pred.float() - target).square().mean()


class CycleGANTask(Task):
    name = "cyclegan"
    has_fy = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        kw = self._net_kw()
        w = self.mc.base_width
        for key in ("G_A", "G_B"):
            self.nets[key] = ResnetGenerator(w, **kw)
        for key in ("D_A", "D_B"):
            self.nets[key] = NLayerDiscriminator(w, **kw)
        # the published optimizers: Adam(G_A + G_B), Adam(D_A + D_B)
        self.gen_params = (list(self.nets["G_A"].parameters())
                           + list(self.nets["G_B"].parameters()))
        self.disc_params = (list(self.nets["D_A"].parameters())
                            + list(self.nets["D_B"].parameters()))
        self.opt_g = self._adam(self.gen_params)
        self.opt_d = self._adam(self.disc_params)
        s = self.mc.image_size
        #: pool_A holds G_B's fakes (domain A), pool_B G_A's
        self.pools = {k: ImagePool(k, POOL_SIZE, (3, s, s), self.mc.dtype,
                                   self.device) for k in ("A", "B")}
        self.pool_stream: Optional[torch.Generator] = None

    def init(self, seed: int) -> None:
        """Fresh weights as published: every conv weight N(0, 0.02), every
        bias zero, drawn in state_dict order from one CPU generator seeded
        with `seed`."""
        gen = torch.Generator().manual_seed(seed)
        for net in self.nets.values():
            init_published(net, gen)

    # -- helpers ----------------------------------------------------------

    def _image(self, images) -> torch.Tensor:
        """An NHWC batch in [0, 1] as NCHW f32 in [-1, 1]."""
        return self._nchw(images) * 2.0 - 1.0

    @staticmethod
    def _unit(t: torch.Tensor) -> torch.Tensor:
        """A generator output in [-1, 1] back in [0, 1], NHWC."""
        return Task._nhwc((t + 1.0) * 0.5)

    def _stream(self, generator: Optional[torch.Generator]):
        if generator is None:
            return None
        if self.pool_stream is None:
            self.pool_stream = torch.Generator().manual_seed(
                generator.initial_seed())
        return self.pool_stream

    def _gen_losses(self, a, b):
        """G_loss, its terms and the fakes (G_A(a), G_B(b)): the six
        generator passes and the two discriminator passes of the G step."""
        G_A, G_B = self.nets["G_A"], self.nets["G_B"]
        D_A, D_B = self.nets["D_A"], self.nets["D_B"]
        fake_B = G_A(a)
        rec_A = G_B(fake_B)
        fake_A = G_B(b)
        rec_B = G_A(fake_A)
        idt_A = G_A(b)
        idt_B = G_B(a)
        terms = {
            "loss_gan_g_y_fake": _lsgan(D_A(fake_B), 1.0),
            "loss_gan_g_x_fake": _lsgan(D_B(fake_A), 1.0),
            "loss_cycle": losses.cycle_consistency_loss(a, b, rec_A, rec_B),
            "loss_identity": losses.identity_loss(a, b, idt_B, idt_A),
        }
        terms["loss_gan_g"] = (terms["loss_gan_g_x_fake"]
                               + terms["loss_gan_g_y_fake"])
        g_loss = (self.lc.lambda_gan * terms["loss_gan_g"]
                  + self.lc.lambda_cycle * terms["loss_cycle"]
                  + self.lc.lambda_identity * terms["loss_identity"])
        return g_loss, terms, fake_B, fake_A

    def _disc_losses(self, a, b, fake_B, fake_A):
        """D_loss and its terms on the images the discriminators see."""
        D_A, D_B = self.nets["D_A"], self.nets["D_B"]
        pred = {"y_real": D_A(b), "y_fake": D_A(fake_B),
                "x_real": D_B(a), "x_fake": D_B(fake_A)}
        terms = {}
        for k, p in pred.items():
            terms[f"D_loss_{k}"] = _lsgan(p, 1.0 if k.endswith("real")
                                          else 0.0)
            terms[f"d_{k}_mean"] = p.float().mean()
        d_loss = (0.5 * (terms["D_loss_y_real"] + terms["D_loss_y_fake"])
                  + 0.5 * (terms["D_loss_x_real"] + terms["D_loss_x_fake"]))
        return d_loss, terms

    # -- protocol ----------------------------------------------------------

    @classmethod
    def refuse_parallel(cls, data_ranks: int, rows_split: bool) -> None:
        """Raise where a CycleGAN run would use more than one device: more
        than one data rank, or rows split across ranks."""
        if rows_split:
            raise NotImplementedError(NO_SPATIAL)
        if data_ranks > 1:
            raise NotImplementedError(NO_DATA)

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One alternating step: G_A + G_B on L_G, then D_A + D_B on L_D over
        the pools' images of the pre-update fakes. batch["x"] (domain A)
        and batch["y"] (domain B) are (B, S, S, 3) NHWC in [0, 1]; `eps`
        must be None or empty (no variational pass). `generator` seeds the
        pools' decisions at the first step that hands one in. Returns the
        metrics as 0-d f32 tensors on the device, with 'nan_detected' 1.0
        when an update was skipped."""
        group = dp.dp_group()
        self.refuse_parallel(
            1 if group is None else dist.get_world_size(group),
            spatial.current() is not None)
        self._eps(eps, ())
        a, b = self._image(batch["x"]), self._image(batch["y"])
        g_loss, g_terms, fake_B, fake_A = self._gen_losses(a, b)
        nan_g = self._step(self.opt_g, g_loss, self.gen_params, batch)
        fake_B, fake_A = fake_B.detach(), fake_A.detach()

        stream = self._stream(generator)
        seen_B = self.pools["B"].query(fake_B, stream)
        seen_A = self.pools["A"].query(fake_A, stream)
        del fake_B, fake_A
        d_loss, d_terms = self._disc_losses(a, b, seen_B, seen_A)
        nan_d = self._step(self.opt_d, d_loss, self.disc_params, batch)
        metrics = {"total_loss": g_loss + d_loss, "G_loss": g_loss,
                   "D_loss": d_loss, **g_terms, **d_terms}
        return self._scalars(metrics, max(nan_g, nan_d))

    @torch.no_grad()
    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        """The step's losses without updates, the discriminators on the
        fresh fakes (the pools are left as they are), plus the images 'Gx'
        (G_A(x)) and 'Fy' (G_B(y)), NHWC in [0, 1], compute dtype."""
        self._eps(eps, ())
        a, b = self._image(batch["x"]), self._image(batch["y"])
        g_loss, g_terms, fake_B, fake_A = self._gen_losses(a, b)
        d_loss, d_terms = self._disc_losses(a, b, fake_B, fake_A)
        metrics = {"total_loss": g_loss + d_loss, "G_loss": g_loss,
                   "D_loss": d_loss, **g_terms, **d_terms}
        metrics = {k: v.float() for k, v in metrics.items()}
        metrics["Gx"] = self._unit(fake_B)
        metrics["Fy"] = self._unit(fake_A)
        return metrics

    @torch.no_grad()
    def generate(self, batch: Mapping[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """G_A(2x - 1) mapped back to [0, 1]: batch["x"] is (B, S, S, 3)
        NHWC in [0, 1]; returns (B, S, S, 3) NHWC in the compute dtype.
        `generator` is not drawn from; `eps` must be None."""
        if eps is not None:
            raise ValueError("cyclegan: generate takes no eps (no "
                             "variational pass)")
        return self._unit(self.nets["G_A"](self._image(batch["x"])))
