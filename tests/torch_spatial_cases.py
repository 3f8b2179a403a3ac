"""The cases of tests/test_torch_spatial.py, run by every rank of a gloo
group (``run_rank``, through ``parallel.mesh.spawn``) and, where a case has
a one-process side, by this process under a spatial scope of 1
(``run_cases(inputs, None)``).

This module imports torch and the port only: the spawned ranks must not
import JAX (the pytest process that spawns them has it loaded, with its
threads). Inputs and results cross as ``torch.save`` files. Small size:
image 32, base 8, latent 8, f32, one torch thread a process. Every rank
is given its data shard's whole images; the engine (or the case, for the
ops) keeps its rows.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.engine import Engine
from vae_cyclegan_tpu_torch.models.networks import SpectralConv
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.ops import instance_norm as inn
from vae_cyclegan_tpu_torch.ops.padding import reflect_pad
from vae_cyclegan_tpu_torch.ops.reflect_conv import halo_conv
from vae_cyclegan_tpu_torch.ops.starved_conv import spatial_reflect_conv
from vae_cyclegan_tpu_torch.parallel import mesh, spatial

IMAGE, BASE, LATENT = 32, 8, 8
#: the op cases: (name, x shape, w shape, stride, pad, path) at image
#: height 32 (k3 and k7 'same', the discriminator's k4 s2 pad 1), and the
#: 1-row bottleneck shard of image 32 at S = 2 (k3 over 2 global rows)
CONV_CASES = [
    ("k3", (2, 4, 32, 32), (5, 4, 3, 3), 1, 1, "halo"),
    ("k7", (2, 4, 32, 32), (5, 4, 7, 7), 1, 3, "halo"),
    ("k4s2", (2, 4, 32, 32), (5, 4, 4, 4), 2, 1, "halo"),
    ("k3_one_row", (2, 4, 2, 8), (5, 4, 3, 3), 1, 1, "halo"),
    ("strip_k7_head", (2, 3, 32, 32), (8, 3, 7, 7), 1, 3, "strip"),
    ("strip_k7_tail", (2, 8, 32, 32), (3, 8, 7, 7), 1, 3, "strip"),
    ("strip_k3_u4", (2, 4, 32, 32), (8, 4, 3, 3), 1, 1, "strip"),
]
#: the IN cases: (shape, act, order, mode)
IN_CASES = [
    ((2, 8, 32, 32), "relu", "act_norm", "tiled"),
    ((2, 8, 32, 32), "leaky_relu", "norm_act", "tiled"),
    ((2, 16, 4, 4), "identity", "act_norm", "auto"),
    ((2, 16, 2, 2), "tanh", "act_norm", "plain"),
]


def rows_of(t, rank: int, size: int, dim: int = 2):
    """Spatial rank `rank`'s rows of a global tensor along `dim`."""
    h = t.shape[dim] // size
    return t.narrow(dim, rank * h, h)


def task_for(name: str, params, paired: bool = True, remat: bool = False,
             dtype=torch.float32):
    task = create_task(name, model=ModelConfig(IMAGE, LATENT, BASE, dtype,
                                               remat=remat),
                       paired=paired, device="cpu")
    task.load_state_dict(params, strict=True)
    if dtype == torch.float64:
        task.nets.to(torch.float64)
    return task


def snapshot(task) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer, and every Adam state tensor, copied."""
    out = {f"sd/{k}": v.detach().clone()
           for k, v in task.state_dict().items()}
    for name, opt in task.optimizers().items():
        for i, state in opt.state_dict()["state"].items():
            for k, v in state.items():
                out[f"{name}/{i}/{k}"] = torch.as_tensor(v).clone()
    return out


def floats(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()
            if k not in ("Gx", "Fy")}


def data_rows(a, lay: spatial.Layout):
    """The data shard of a global host batch (whole images)."""
    b = a.shape[0] // lay.data_size
    return torch.as_tensor(np.ascontiguousarray(
        a[lay.data_rank * b:(lay.data_rank + 1) * b]))


@contextlib.contextmanager
def widened():
    """The f64 case: the task's NHWC batches widened to f64, and
    ``Tensor.float()`` keeping f64 values f64, so the port's f32 statistics
    (InstanceNorm, losses, the latent) run in f64 too."""
    from vae_cyclegan_tpu_torch.models.tasks.base import Task

    orig_float, orig_nchw = torch.Tensor.float, Task._nchw
    default = torch.get_default_dtype()
    torch.Tensor.float = (lambda self: self if self.dtype == torch.float64
                          else orig_float(self))
    Task._nchw = lambda self, images: torch.as_tensor(images).to(
        self.device, torch.float64).permute(0, 3, 1, 2).contiguous()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, Task._nchw = orig_float, orig_nchw
        torch.set_default_dtype(default)


def op_cases(inputs: dict, lay: spatial.Layout) -> dict:
    """Each op on this rank's rows: its output rows and the gradients of a
    fixed cotangent (dx rows, dw summed over the group by the caller)."""
    out = {}
    r, s = lay.rank, lay.size
    with spatial.spatial_scope(lay):
        for (name, _, _, stride, pad, path), (x, w, g) in zip(
                CONV_CASES, inputs["convs"]):
            xl = rows_of(x, r, s).clone().requires_grad_(True)
            wl = w.clone().requires_grad_(True)
            if path == "halo":
                y = halo_conv(xl, wl, stride, pad)
            else:
                y = spatial_reflect_conv(xl, wl)
            y.backward(rows_of(g, r, s))
            out[f"conv/{name}"] = (y.detach(), xl.grad, wl.grad)
        for (shape, act, order, mode), (x, g) in zip(IN_CASES,
                                                     inputs["in"]):
            xl = rows_of(x, r, s).clone().requires_grad_(True)
            y = inn.instance_norm_act(xl, act=act, order=order, mode=mode)
            y.backward(rows_of(g, r, s))
            out[f"in/{mode}/{act}"] = (y.detach(), xl.grad)
        sc = SpectralConv(16, 1, 4)
        sc.load_state_dict(inputs["spectral"]["sd"])
        x = inputs["spectral"]["x"]
        xl = rows_of(x, r, s).clone().requires_grad_(True)
        y = sc(xl, update_stats=True)
        y.sum().backward()
        out["spectral"] = (y.detach(), xl.grad, sc.weight_orig.grad,
                           sc.bias.grad, sc.weight_u.clone())
    return out


def step_cases(inputs: dict, lay: spatial.Layout, group,
               only: Optional[tuple] = None) -> dict:
    """One train step of each family through the engine on this rank's data
    shard (the engine keeps the rows), then eval_step and generate."""
    out = {}
    for name, case in inputs["steps"].items():
        if only is not None and name not in only:
            continue
        task = task_for(name, case["params"], case["paired"])
        engine = Engine(task, seed=0, group=group, spatial=lay)
        batch = {k: data_rows(v, lay) for k, v in case["batch"].items()}
        eps = [data_rows(e, lay) for e in case["eps"]] or None
        m = engine.train_step(batch, eps=eps)
        out[f"step/{name}"] = {"metrics": floats(m), "state": snapshot(task)}
    if only is not None:
        return out

    # eval_step (noise given) and generate (noise drawn): gathered images
    ev = inputs["eval"]
    task = task_for("cyclevaegan", ev["params"], paired=False)
    engine = Engine(task, seed=0, group=group, spatial=lay)
    batch = {k: data_rows(v, lay) for k, v in ev["batch"].items()}
    m = engine.eval_step(batch, eps=[data_rows(e, lay) for e in ev["eps"]])
    gen = torch.Generator().manual_seed(5)
    out["eval/cyclevaegan"] = {
        "metrics": floats(m), "Gx": m["Gx"].clone(), "Fy": m["Fy"].clone(),
        "generate": engine.generate(batch, generator=gen).clone()}

    # remat: the recompute re-enters the halo exchanges and all-reduces in
    # the same order on every rank
    case = inputs["steps"]["cyclevaegan"]
    batch = {k: data_rows(v, lay) for k, v in case["batch"].items()}
    eps = [data_rows(e, lay) for e in case["eps"]]
    task = task_for("cyclevaegan", case["params"], case["paired"],
                    remat=True)
    m = Engine(task, seed=0, group=group, spatial=lay).train_step(batch,
                                                                   eps=eps)
    out["remat/cyclevaegan"] = {"metrics": floats(m), "state": snapshot(task)}

    # the noise drawn, not given: dp_normal's global array, this rank's rows
    case = inputs["steps"]["vae"]
    task = task_for("vae", case["params"])
    m = Engine(task, seed=3, group=group, spatial=lay).train_step(
        {k: data_rows(v, lay) for k, v in case["batch"].items()})
    out["drawn/vae"] = {"metrics": floats(m), "state": snapshot(task)}

    # the f64 step: the sharding alone, without f32 rounding (and, in one
    # process, the exact step that (a)'s bars measure f32 rounding against)
    with widened():
        for name in inputs["steps"]:
            case = inputs["steps"][name]
            task = task_for(name, case["params"], case["paired"],
                            dtype=torch.float64)
            engine = Engine(task, seed=0, group=group, spatial=lay)
            batch = {k: data_rows(v.astype(np.float64), lay)
                     for k, v in case["batch"].items()}
            eps = [data_rows(e.astype(np.float64), lay)
                   for e in case["eps"]] or None
            m = engine.train_step(batch, eps=eps)
            out[f"f64/{name}"] = {"metrics": floats(m),
                                  "state": snapshot(task)}
    return out


def run_cases(inputs: dict, group, only: Optional[tuple] = None) -> dict:
    """Every case on this rank (a spatial group of `inputs["spatial"]` over
    `group`), or in this process at a spatial group of 1 (`group` None)."""
    torch.set_num_threads(1)
    if group is None:
        lay = spatial.single()
        out = {}
    else:
        lay = mesh.make_spatial(inputs["spatial"])
        out = {"layout": (lay.size, lay.rank, lay.data_size, lay.data_rank)}
    if only is None and lay.data_size == 1:
        out.update(op_cases(inputs, lay))
    out.update(step_cases(inputs, lay, group, only))
    return out


def run_rank(device, in_path: str, out_dir: str, only=None) -> None:
    """One rank's run of every case (``mesh.spawn``'s `fn`)."""
    inputs = torch.load(in_path, weights_only=False)
    out = run_cases(inputs, dist.group.WORLD, only)
    torch.save(out, Path(out_dir) / f"rank{dist.get_rank()}.pt")


def refusal(device, image: int, size: int, out_dir: str) -> None:
    """A generator forward at `image` on a spatial group of `size`: the
    error the first site that cannot take its local rows raises (none when
    every site takes them)."""
    torch.set_num_threads(1)
    lay = mesh.make_spatial(size)
    task = create_task("autoencoder", model=ModelConfig(image, LATENT, BASE),
                       device="cpu")
    task.init(0)
    x = torch.rand(1, image, image, 3)
    msg = None
    try:
        with torch.no_grad():
            Engine(task, group=dist.group.WORLD, spatial=lay).generate(
                {"x": x})
    except ValueError as e:
        msg = str(e)
    torch.save(msg, Path(out_dir) / f"refusal{dist.get_rank()}.pt")


def conv_reference(x, w, stride: int, pad: int):
    """The one-process conv of a conv case."""
    return F.conv2d(reflect_pad(x, pad), w, stride=stride)
