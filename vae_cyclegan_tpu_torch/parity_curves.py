"""Loss-curve trajectories of the port: its side of
``scripts/parity_curves.py``.

``run_trajectory`` trains one task for N steps on the JAX harness's
protocol and returns the per-step ``G_loss``, ``D_loss`` (where the task
has one) and the other loss terms:

  * batches: ``np.random.RandomState(seed)``, per step x then y, each
    ``rand(batch, S, S, 3)`` f32, all drawn before the first step
    (``scripts/parity_curves.py:116``);
  * noise: ``np.random.RandomState(seed + 1)``, ``randn(batch, latent,
    S/16, S/16)`` NCHW per variational pass, ``len(task.train_passes)`` a
    step in the passes' call order (the harness's ``_EPS_PER_STEP``,
    ``:55``, ``:128``), handed to ``train_step(..., eps=...)`` in NHWC.

So the JAX package's task fed the same batches through ``eps_queue`` (the
tests do that: this module imports no JAX) and the port's on any device and
in any dtype walk comparable trajectories. The weights are ``params`` (a
state_dict, e.g. ``utils.jax_import.params_from_jax`` of a JAX state) or
``task.init(seed)``.

``bump_one_ulp`` moves every parameter one ulp (``nextafter``): all of
them up, the counterpart of ``scripts/vaegan_chaos_allulp.py``, or each up
or down by a seeded coin. A trajectory's gaps to such twins are its own
sensitivity band, as the JAX package's probes were for vaegan
(``scripts/vaegan_chaos_probe.py``: the largest of five); a gap between two
implementations is judged against it.

    python -m vae_cyclegan_tpu_torch.parity_curves --archs cyclevaegan \\
        --steps 10 --image_size 256 --batch 4 --runs bf16 f32 f32_ulp \\
        --reference f32 --out chiprun_out/parity_curves.json [--platform cpu]

runs every listed configuration (``<dtype>``, or ``<dtype>_ulp`` /
``<dtype>_ulp<k>`` from the moved weights) of each architecture from the
same weights and data, and writes, per architecture, the curves under the keys of
``docs/parity_curves.json`` (``<run>_G_loss``, ``<run>_components``,
``relative_gap``, ``max_relative_gap``, ``final_relative_gap`` of the first
run against the reference run) and every run's gaps to the reference
(``gaps``: per loss, the gap of the trajectory means, and the largest and
last per-step gaps). The card by default, with TF32 off; ``--platform
cpu`` for the CPU. On the card a step is not deterministic (the reflect
pad's backward adds with atomics), so two runs of one configuration part
after the first update as chaotically as a one-ulp twin does.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.train import device_for

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
#: the loss curves that gaps are taken of, where a task reports them
CURVES = ("G_loss", "D_loss")


def trajectory_inputs(steps: int, image_size: int, batch: int, seed: int,
                      latent_dim: int, passes: int):
    """(batches, eps): `steps` (x, y) NHWC f32 pairs and, per step, the
    `passes` NHWC noise arrays, on the JAX harness's protocol."""
    rng = np.random.RandomState(seed)
    batches = [
        (rng.rand(batch, image_size, image_size, 3).astype(np.float32),
         rng.rand(batch, image_size, image_size, 3).astype(np.float32))
        for _ in range(steps)
    ]
    lat = image_size // 16
    eps_rs = np.random.RandomState(seed + 1)
    drawn = [eps_rs.randn(batch, latent_dim, lat, lat).astype(np.float32)
             for _ in range(steps * passes)]
    eps = [[np.ascontiguousarray(e.transpose(0, 2, 3, 1))
            for e in drawn[i * passes:(i + 1) * passes]]
           for i in range(steps)]
    return batches, eps


@torch.no_grad()
def bump_one_ulp(task, seed: Optional[int] = None) -> None:
    """Every parameter element of the task moved one ulp, in place: up
    (towards +inf) without a seed, else up or down by a coin from a CPU
    generator seeded with `seed`, drawn in parameter order."""
    coins = None if seed is None else torch.Generator().manual_seed(seed)
    for p in task.nets.parameters():
        up = torch.full_like(p, math.inf)
        if coins is not None:
            flip = torch.rand(p.shape, generator=coins) < 0.5
            up = torch.where(flip.to(p.device), -up, up)
        p.copy_(torch.nextafter(p, up))


@torch.no_grad()
def bump_one_element(task, which: int) -> str:
    """One element of one weight tensor moved one ulp up, in place: weight
    tensor `which` (modulo their count; tensors of ndim > 1 only, since the
    biases start at zero), flat index `which` modulo its size. The probe of
    ``scripts/vaegan_chaos_probe.py``. Returns the tensor's name."""
    weights = [(n, p) for n, p in task.nets.named_parameters() if p.dim() > 1]
    name, p = weights[which % len(weights)]
    flat = p.view(-1)
    i = which % flat.numel()
    flat[i] = torch.nextafter(flat[i], flat.new_tensor(math.inf))
    return name


def run_trajectory(arch: str, steps: int, image_size: int, batch: int,
                   seed: int, device, dtype: torch.dtype,
                   instance_norm: str = "auto",
                   params: Optional[Mapping[str, torch.Tensor]] = None, *,
                   base_width: int = 64, latent_dim: int = 64,
                   bump: Optional[int] = None, probe: Optional[int] = None,
                   paired: bool = True) -> Dict[str, object]:
    """`steps` train_steps of `arch` on `device` in `dtype` from `params`
    (else ``task.init(seed)``), moved by ``bump_one_ulp`` when `bump` is
    given (0: every parameter up; k > 0: the coins of seed k), or by
    ``bump_one_element(task, probe)`` when `probe` is.
    Returns ``{"G_loss": [...], "D_loss": [...] (adversarial tasks),
    "components": {metric: [...]}, "nan_detected": [...]}``, one float per
    step."""
    task = create_task(arch, model=ModelConfig(
        image_size, latent_dim, base_width, dtype,
        instance_norm=instance_norm), paired=paired, device=device)
    if params is None:
        task.init(seed)
    else:
        task.load_state_dict(params, strict=True)
    if bump is not None:
        bump_one_ulp(task, bump or None)
    if probe is not None:
        bump_one_element(task, probe)
    batches, eps = trajectory_inputs(steps, image_size, batch, seed,
                                     latent_dim, len(task.train_passes))
    curves: Dict[str, List[float]] = {}
    for (x, y), e in zip(batches, eps):
        metrics = task.train_step({"x": x, "y": y}, eps=e or None)
        for key, value in metrics.items():
            curves.setdefault(key, []).append(float(value))
    out: Dict[str, object] = {k: curves.pop(k) for k in CURVES if k in curves}
    out["nan_detected"] = curves.pop("nan_detected")
    out["components"] = curves
    return out


def mean_gap(got: List[float], want: List[float]) -> float:
    """|mean(got) - mean(want)| / |mean(want)|: the gap of two trajectories'
    means."""
    return abs(float(np.mean(got)) - float(np.mean(want))) / max(
        abs(float(np.mean(want))), 1e-9)


def step_gaps(got: List[float], want: List[float]) -> List[float]:
    return [abs(a - b) / max(abs(b), 1e-9) for a, b in zip(got, want)]


def compare(runs: Mapping[str, Dict], reference: str) -> Dict[str, Dict]:
    """Every run's gaps to the reference run, per curve of CURVES: the gap
    of the means, and the largest and last per-step gaps."""
    ref = runs[reference]
    gaps = {}
    for label, run in runs.items():
        if label == reference:
            continue
        gaps[label] = {}
        for key in CURVES:
            if key in ref:
                per = step_gaps(run[key], ref[key])
                gaps[label][key] = {"mean": mean_gap(run[key], ref[key]),
                                    "max": max(per), "final": per[-1]}
    return gaps


def parse_run(label: str):
    """(dtype, bump) of a run label: ``<dtype>`` (bump None),
    ``<dtype>_ulp`` (0: every parameter one ulp up) or ``<dtype>_ulp<k>``
    (k: each parameter element one ulp up or down by the coins of seed
    k)."""
    dtype_name, _, ulp = label.partition("_")
    seed = ulp[3:]
    if dtype_name not in DTYPES or not (
            ulp == "" or (ulp.startswith("ulp") and (
                seed == "" or (seed.isdigit() and int(seed) > 0)))):
        raise ValueError(f"run {label!r}: expected <dtype>, <dtype>_ulp or "
                         f"<dtype>_ulp<k> (k > 0), dtype one of "
                         f"{sorted(DTYPES)}")
    return DTYPES[dtype_name], (None if ulp == "" else int(seed or 0))


def run_arch(arch: str, labels: List[str], reference: str, steps: int,
             image_size: int, batch: int, seed: int, device,
             instance_norm: str, base_width: int, latent_dim: int) -> Dict:
    """Each run of `labels` (``parse_run``) of `arch` from one set of
    weights, and the record ``main`` writes for it."""
    weights = None
    runs = {}
    for label in labels:
        dtype, bump = parse_run(label)
        if weights is None:
            init = create_task(arch, model=ModelConfig(
                image_size, latent_dim, base_width), device="cpu")
            init.init(seed)
            weights = {k: v.clone() for k, v in init.state_dict().items()}
        runs[label] = run_trajectory(
            arch, steps, image_size, batch, seed, device, dtype,
            instance_norm, weights, base_width=base_width,
            latent_dim=latent_dim, bump=bump)
    record: Dict[str, object] = {
        "architecture": arch, "steps": steps, "image_size": image_size,
        "batch": batch, "seed": seed, "base_width": base_width,
        "latent_dim": latent_dim, "instance_norm": instance_norm,
        "device": str(device), "runs": labels, "reference": reference}
    for label, run in runs.items():
        for key in CURVES:
            if key in run:
                record[f"{label}_{key}"] = run[key]
        record[f"{label}_components"] = run["components"]
        record[f"{label}_nan_detected"] = run["nan_detected"]
    first = next((lb for lb in labels if lb != reference), None)
    if first is not None:
        rel = step_gaps(runs[first]["G_loss"], runs[reference]["G_loss"])
        record.update({"relative_gap": rel, "max_relative_gap": max(rel),
                       "final_relative_gap": rel[-1]})
        record["component_max_relative_gap"] = {
            k: max(abs(a - b) / max(abs(b), 1e-2) for a, b in zip(
                v, runs[reference]["components"][k]))
            for k, v in runs[first]["components"].items()}
    record["gaps"] = compare(runs, reference)
    return record


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--archs", nargs="+", default=["cyclevaegan"])
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--base_width", type=int, default=64)
    p.add_argument("--latent_dim", type=int, default=64)
    p.add_argument("--instance_norm", default="auto",
                   choices=("auto", "tiled"))
    p.add_argument("--runs", nargs="+", default=["bf16", "f32", "f32_ulp"],
                   help="configurations to run: <dtype>, <dtype>_ulp or "
                        "<dtype>_ulp<k> (bf16, f32; _ulp: every parameter "
                        "one ulp up; _ulp<k>: each element one ulp up or "
                        "down by the coins of seed k)")
    p.add_argument("--reference", default="f32",
                   help="the run every other run is compared with")
    p.add_argument("--platform", type=str, default=None,
                   help="the card by default, cpu for the CPU")
    p.add_argument("--out", type=str,
                   default="chiprun_out/parity_curves.json")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.reference not in args.runs:
        raise SystemExit(f"--reference {args.reference} is not one of "
                         f"--runs {args.runs}")
    device = device_for(args.platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (the trajectories run on the card "
                           "by default); pass --platform cpu to run on the "
                           "CPU")
    if device.type == "cuda":  # f32 convs in full f32, as on the CPU
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    for arch in args.archs:
        print(f"running {arch}: {args.runs} for {args.steps} steps on "
              f"{device}...")
        rec = run_arch(arch, args.runs, args.reference, args.steps,
                       args.image_size, args.batch, args.seed, device,
                       args.instance_norm, args.base_width, args.latent_dim)
        for label, per in rec["gaps"].items():
            print(f"  {arch} {label} vs {args.reference}: " + ", ".join(
                f"{k} mean gap {g['mean']:.4%} (max step gap "
                f"{g['max']:.4%})" for k, g in per.items()))
        results.append(rec)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
