"""Serialized generator export for serving (counterpart of
``vae_cyclegan_tpu/utils/export.py``).

``export_generator`` traces a task's generator (``Task.generate``, the
reference's ``model(x)[0]``) into a ``torch.export.ExportedProgram``: the
weights are carried in the program, the batch dimension is symbolic unless
``batch_size`` is given, and the hand kernels stay in place as the custom
operators of ``kernels.ops`` (``vct::in_act``, ``vct::starved_conv``, ...,
one node per call that the dispatch rules send to a kernel), so the program
launches them when it runs on the card and their plain versions on the CPU.
There is no kernel-free export: JAX exports with every Pallas kernel off, the
port exports the path it serves.

The program's signature is ``(x: f32[b, S, S, 3] NHWC, eps: f32[b, S/16,
S/16, latent_dim] NHWC) -> f32[b, S, S, 3] NHWC``: ``eps`` is the
reparameterization noise, which the deterministic families ignore.
``torch.export`` cannot trace a ``torch.Generator``, so the seed is not an
input of the program as it is in JAX's; ``load`` returns a ``Served``
callable ``(x, seed)`` that draws ``eps`` from ``torch.Generator(device).
manual_seed(seed)`` on the program's device as ``inference.run_inference``
does, then runs the program. ``save`` / ``load`` are ``torch.export.save`` /
``load`` with the serving metadata beside the program; importing this
module registers the ``vct`` operators, which ``torch.export.load`` needs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from vae_cyclegan_tpu_torch.kernels import ops as _kernel_ops  # noqa: F401

_META = "vct_serving.json"


def _serving_modules(task) -> Dict[str, nn.Module]:
    """The modules ``task.generate`` runs, so that the program carries no
    other weights: G for the tasks that have one, side A of the Double
    networks, else the task's one network."""
    nets = task.nets
    if isinstance(nets, nn.ModuleDict):
        return {"G": nets["G"]}
    if hasattr(nets, "decoder_A"):
        names = ("encoder", "vae_encoder_block_A", "vae_decoder_block_A",
                 "decoder_A")
        return {n: getattr(nets, n) for n in names if hasattr(nets, n)}
    return {"net": nets}


class _Generate(nn.Module):
    """``task.generate`` as a module over the modules it runs, NHWC f32 in
    and out."""

    def __init__(self, task):
        super().__init__()
        self.nets = nn.ModuleDict(_serving_modules(task))
        self._task = (task,)  # not a submodule: its other nets stay out
        self.variational = bool(task.train_passes)

    def forward(self, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        task = self._task[0]
        out = task.generate({"x": x}, eps=eps if self.variational else None)
        return out.float()


def export_generator(task, batch_size: Optional[int] = None
                     ) -> torch.export.ExportedProgram:
    """Trace ``task.generate`` on the task's device into an
    ``ExportedProgram`` of signature ``(x, eps) -> image`` (module
    docstring), with the batch symbolic when `batch_size` is None (one
    program, any batch size from 1) and fixed otherwise."""
    s, latent = task.mc.image_size, task.mc.latent_dim
    b = 2 if batch_size is None else int(batch_size)
    x = torch.zeros((b, s, s, 3), device=task.device)
    eps = torch.zeros((b, s // 16, s // 16, latent), device=task.device)
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1, max=65535)
        dynamic = ({0: batch}, {0: batch})
    # under no_grad the ops' inference path is traced flat: no autograd
    # Function and no grad-mode region in the graph
    with torch.no_grad():
        program = torch.export.export(_Generate(task), (x, eps),
                                      dynamic_shapes=dynamic)
    program.vct_meta = {
        "architecture": task.name, "image_size": s, "latent_dim": latent,
        "variational": bool(task.train_passes),
        "batch": "symbolic" if batch_size is None else b,
        "dtype": str(task.mc.dtype).replace("torch.", ""),
        "instance_norm": task.mc.instance_norm,
    }
    return program


def save(program: torch.export.ExportedProgram, path: os.PathLike) -> None:
    """Write the program and its serving metadata to `path`."""
    torch.export.save(program, path, extra_files={
        _META: json.dumps(program.vct_meta)})


class Served:
    """A loaded program as a serving callable: ``served(x, seed)`` draws
    the noise from `seed` (``inference.run_inference``'s generator, on the
    program's device) and returns the f32 NHWC image, unclipped, as
    JAX's exported ``call(x, seed)`` does; ``run(x, eps)`` takes the noise
    given. ``program`` and ``meta`` are the ``ExportedProgram`` and its
    metadata."""

    def __init__(self, program: torch.export.ExportedProgram, meta: dict):
        self.program = program
        self.meta = meta
        self.module = program.module()
        self.device = next(iter(program.state_dict.values())).device

    def noise(self, batch: int, seed: int) -> torch.Tensor:
        """The NHWC noise of a batch of `batch` drawn from `seed` as
        ``networks.VariationalEncoderBlock`` draws it (NCHW, then
        transposed)."""
        s, latent = self.meta["image_size"] // 16, self.meta["latent_dim"]
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        eps = torch.randn((batch, latent, s, s), generator=gen,
                          device=self.device, dtype=torch.float32)
        return eps.permute(0, 2, 3, 1)

    def __call__(self, x, seed: int = 0) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        x = x.to(self.device, torch.float32)
        s = self.meta["image_size"]
        fixed = self.meta["batch"]
        if x.dim() != 4 or tuple(x.shape[1:]) != (s, s, 3) or (
                fixed != "symbolic" and x.shape[0] != fixed):
            raise ValueError(
                f"the program takes f32[{'b' if fixed == 'symbolic' else fixed}"
                f", {s}, {s}, 3] NHWC, got {tuple(x.shape)}")
        return self.run(x, self.noise(x.shape[0], seed))

    @torch.no_grad()
    def run(self, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """The program on NHWC `x` and `eps` on its device, without
        autograd (the weights are parameters that require grad)."""
        return self.module(x, eps)


def load(path: os.PathLike) -> Served:
    """Read a program written by ``save``; the ``vct`` operators are
    registered (this module imports ``kernels.ops``) before it loads."""
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    program.vct_meta = meta
    return Served(program, meta)
