"""Task base: one object per architecture that owns its networks, their
device, their weights and optimizers, and exposes the protocol

    init(seed)                                   draw fresh weights
    train_step(batch, eps=None, generator=None)  -> metrics (one step)
    eval_step(batch, eps=None, generator=None)   -> metrics + images
    generate(batch, generator=None, eps=None)    -> Gx, NHWC

Counterpart of ``vae_cyclegan_tpu/models/tasks/base.py``. The JAX task is
pure and threads a ``TrainState`` (``vae_cyclegan_tpu/models/state.py``),
which has no counterpart here: the task holds the state, the networks'
parameters and spectral buffers (``state_dict``) and the Adam states of its
optimizers. Batches are NHWC, as in the JAX package.

A task runs on the card unless the caller asks for another device: the
default device is ``cuda``, and constructing a task there without a CUDA
device raises.

Reparameterization noise: each task names its variational generator passes
in call order (``train_passes``, ``eval_passes``). ``eps`` is then a list of
NHWC noise tensors, one per pass in that order, and ``generate``'s ``eps``
the one of its first pass; without them the noise is drawn from
``generator`` (or the device's default one).

Rematerialization (``ModelConfig.remat``): the training steps wrap the
generator passes JAX's tasks wrap in ``jax.checkpoint`` in
``torch.utils.checkpoint`` (``_maybe_remat``), so their activations are
recomputed in the backward. A variational pass's noise is then drawn before
the checkpointed call and passed in: ``checkpoint`` replays only the default
generators, so noise drawn inside from an explicit ``torch.Generator``
would differ in the recompute and the gradient would be wrong.
"""

from __future__ import annotations

import functools
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from vae_cyclegan_tpu_torch.config import LossConfig, ModelConfig, OptimConfig
from vae_cyclegan_tpu_torch.models.blocks import ReflectConv
from vae_cyclegan_tpu_torch.models.networks import (
    SpectralConv,
    VariationalAutoencoderNet,
)
from vae_cyclegan_tpu_torch.parallel import dp, mesh
from vae_cyclegan_tpu_torch.utils import nan_dump


class Task:
    """Base class; subclasses set `name`, fill `self.nets` and implement
    the protocol."""

    name: str = "base"
    #: whether eval_step emits a second image stream 'Fy' (Cycle/Double archs)
    has_fy: bool = False
    #: the variational generator passes of train_step / eval_step, in order
    train_passes: Tuple[str, ...] = ()

    def __init__(self, model: Optional[ModelConfig] = None,
                 optim: Optional[OptimConfig] = None,
                 loss: Optional[LossConfig] = None, paired: bool = True,
                 device="cuda"):
        self.mc = model or ModelConfig()
        self.oc = optim or OptimConfig()
        self.lc = loss or LossConfig()
        self.paired = paired
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{self.name}: no CUDA device (the tasks run on the card by "
                "default); pass device='cpu' to run on the CPU")
        #: the task's networks; their state_dict keys carry the reference's
        #: prefixes ("G.", "F.", "DX.", ...)
        self.nets = nn.ModuleDict()

    @property
    def eval_passes(self) -> Tuple[str, ...]:
        return self.train_passes

    def _net_kw(self) -> dict:
        """Constructor arguments every network of the task shares."""
        return dict(dtype=self.mc.dtype, device=self.device,
                    instance_norm=self.mc.instance_norm)

    def init(self, seed: int) -> None:
        """Fresh weights: every conv weight Kaiming-normal (fan_out, with
        its module's gain: relu, or leaky_relu for the discriminator the
        reference leaves at its own init), every bias zero, the spectral
        vectors unit-normal, drawn in state_dict order from one CPU
        generator seeded with `seed`."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.nets.modules():
            if isinstance(module, (ReflectConv, SpectralConv)):
                module.reset_parameters(gen)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.nets.state_dict()

    def load_state_dict(self, sd: Mapping[str, torch.Tensor],
                        strict: bool = True):
        return self.nets.load_state_dict(sd, strict=strict)

    # -- helpers ----------------------------------------------------------

    def _adam(self, params: Iterable[nn.Parameter]) -> torch.optim.Adam:
        """Adam with the reference's settings (betas 0.5/0.999, eps 1e-8)."""
        return torch.optim.Adam(list(params), lr=self.oc.lr,
                                betas=self.oc.betas, eps=self.oc.eps)

    def optimizers(self) -> Dict[str, torch.optim.Optimizer]:
        """The task's Adams under the reference checkpoint's keys:
        {"optimizer"} for one optimizer, {"optimizer_G", "optimizer_D"} for
        the adversarial tasks (``utils.checkpoint``)."""
        if hasattr(self, "opt"):
            return {"optimizer": self.opt}
        return {"optimizer_G": self.opt_g, "optimizer_D": self.opt_d}

    @staticmethod
    def _finite_update(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                       params: Sequence[nn.Parameter],
                       grads: Sequence[torch.Tensor],
                       dump: Optional[Callable] = None) -> float:
        """Apply the optimizer step only when the loss is finite; on a
        non-finite loss the step is skipped whole (parameters, moments and
        Adam's count stay as they were) and ``dump()`` is called where
        given (``utils.nan_dump``). Returns the nan_detected flag, 1.0
        when skipped. Reading the loss's finiteness waits for the device.

        In a data-parallel scope (``parallel.dp``) the loss and the
        gradients are first meaned across the ranks, in one buffer and one
        all_reduce (JAX's pmean in its gate), so every rank takes the same
        branch and applies the same update."""
        loss, *grads = dp.sync([loss, *grads])
        finite = bool(torch.isfinite(loss))
        if finite:
            for p, g in zip(params, grads):
                p.grad = g
            optimizer.step()
        elif dump is not None:
            dump()
        for p in params:
            p.grad = None
        return 0.0 if finite else 1.0

    def _step(self, optimizer: torch.optim.Optimizer, loss: torch.Tensor,
              params: Sequence[nn.Parameter],
              batch: Optional[Mapping] = None) -> float:
        """The gradient of `loss` over `params`, then ``_finite_update``;
        while NaN dumps are enabled, its skip branch dumps `batch` and the
        parameters and gradients under their state_dict names (on the
        primary rank only, in a process group)."""
        grads = torch.autograd.grad(loss, params)
        if not nan_dump.enabled() or not mesh.is_primary():
            return self._finite_update(optimizer, loss, params, grads)

        def dump():
            names = {id(p): n for n, p in self.nets.named_parameters()}
            nan_dump.write_dump(
                loss, batch, {names[id(p)]: p for p in params},
                {names[id(p)]: g for p, g in zip(params, grads)})

        return self._finite_update(optimizer, loss, params, grads, dump)

    def _scalars(self, metrics: Mapping[str, torch.Tensor],
                 nan: float) -> Dict[str, torch.Tensor]:
        """A train_step's metrics as detached 0-d f32 tensors on the device,
        with 'nan_detected'."""
        out = {k: v.detach().float() for k, v in metrics.items()}
        out["nan_detected"] = torch.tensor(nan, device=self.device)
        return out

    def _nchw(self, images) -> torch.Tensor:
        """An NHWC float batch (numpy or torch) as an f32 NCHW tensor on the
        task's device."""
        t = torch.as_tensor(images).to(self.device, torch.float32)
        return t.permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def _nhwc(t: torch.Tensor) -> torch.Tensor:
        return t.permute(0, 2, 3, 1)

    def _eps(self, eps: Optional[List],
             passes: Sequence[str]) -> List[Optional[torch.Tensor]]:
        """The noise of `passes` as NCHW tensors on the device, or Nones (the
        networks then draw it)."""
        if eps is None:
            return [None] * len(passes)
        if len(eps) != len(passes):
            raise ValueError(f"{self.name}: {len(eps)} eps tensors, expected "
                             f"{len(passes)} ({', '.join(passes)})")
        return [self._nchw(e) for e in eps]

    def _generate_eps(self, eps) -> Optional[torch.Tensor]:
        """``generate``'s eps (one NHWC tensor or None) as the noise of the
        first pass; a task without one refuses a tensor."""
        e = self._eps(None if eps is None else [eps], self.train_passes[:1])
        return e[0] if e else None

    def _remat(self) -> bool:
        """Whether generator passes are rematerialized now: the
        configuration asks for it and autograd is recording."""
        return self.mc.remat and torch.is_grad_enabled()

    def _maybe_remat(self, fn: Callable) -> Callable:
        """`fn` under ``torch.utils.checkpoint`` (non-reentrant) while
        ``_remat()``, else `fn` itself (JAX's ``_maybe_remat``)."""
        if not self._remat():
            return fn
        return functools.partial(checkpoint, fn, use_reentrant=False)

    def _noise(self, v: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        """The noise a variational pass over the NCHW image batch `v` would
        draw from `generator`: (B, latent_dim, H/16, W/16) f32, drawn as
        ``networks.VariationalEncoderBlock`` draws it (``dp.dp_normal``)."""
        n, _, h, w = v.shape
        return dp.dp_normal(generator, (n, self.mc.latent_dim, h // 16,
                                        w // 16), v.device)

    def _gen(self, net: nn.Module, v: torch.Tensor,
             eps: Optional[torch.Tensor],
             generator: Optional[torch.Generator]):
        """(image, mu, logvar) of one generator pass, rematerialized while
        ``_remat()``; mu and logvar are None for an autoencoder."""
        fwd = self._maybe_remat(net)
        if isinstance(net, VariationalAutoencoderNet):
            if eps is None and self._remat():
                eps = self._noise(v, generator)
            return fwd(v, eps, generator)
        return fwd(v), None, None

    # -- protocol ----------------------------------------------------------

    def train_step(self, batch: Mapping, eps: Optional[List] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def eval_step(self, batch: Mapping, eps: Optional[List] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def generate(self, batch: Mapping[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward producing Gx only (the reference's ``model(...)[0]``)."""
        raise NotImplementedError
