"""Evaluation / comparison CLI on the card.

    python -m vae_cyclegan_tpu_torch.test --runs_dir runs ...

Counterpart of the JAX package's ``test.py`` (reference test.py:31-604):
discovers finished runs (``args.json`` + ``best_model/``), rebuilds each
model from its saved args, runs deterministic inference on the test split,
and writes per-sample comparison figures, per-model grids and a
``summary.json`` per (dataset, modality-pair) group, with the same keys.
The metrics (``group_metrics``) are computed apart from the figure writers,
which import matplotlib when they draw. The run is on the card unless
``--platform cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from vae_cyclegan_tpu_torch.config import LossConfig, ModelConfig, OptimConfig
from vae_cyclegan_tpu_torch.data import (
    AugmentConfig,
    DataLoader,
    HypersimDataset,
    SatelliteMapDataset,
    Subset,
    Summer2WinterDataset,
    split_dataset,
)
from vae_cyclegan_tpu_torch.inference import normalize_batch_keys, run_inference
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.train import device_for
from vae_cyclegan_tpu_torch.utils import (
    checkpoint_exists,
    load_checkpoint,
    metrics,
)


def discover_runs(runs_dir: str) -> List[Dict]:
    """Scan runs/*/ for args.json + best_model (reference test.py:31-70)."""
    runs = []
    runs_path = Path(runs_dir)
    if not runs_path.is_dir():
        return runs
    for run_dir in sorted(runs_path.iterdir()):
        if not run_dir.is_dir():
            continue
        args_file = run_dir / "args.json"
        best = run_dir / "best_model"
        if args_file.exists() and checkpoint_exists(best):
            with open(args_file) as f:
                run_args = json.load(f)
            runs.append({
                "run_dir": run_dir,
                "name": run_dir.name,
                "args": run_args,
                "checkpoint": best,
            })
    print(f"Discovered {len(runs)} completed runs in {runs_dir}")
    return runs


def load_model_for_inference(run: Dict, device="cuda"):
    """Rebuild the task on `device` from the run's saved args and restore
    its best checkpoint (reference test.py:110-142)."""
    a = run["args"]
    mc = ModelConfig(
        image_size=a.get("image_size", 256),
        latent_dim=a.get("latent_dim", 64),
        base_width=a.get("base_width", 64),
        dtype=torch.bfloat16 if a.get("precision") == "bf16" else torch.float32,
    )
    task = create_task(
        a["architecture"],
        model=mc,
        optim=OptimConfig(lr=a.get("lr", 2e-4)),
        loss=LossConfig(
            lambda_kl=a.get("lambda_kl", 1e-5),
            lambda_gan=a.get("lambda_gan", 1.0),
            lambda_identity=a.get("lambda_identity", 5.0),
            lambda_cycle=a.get("lambda_cycle", 10.0),
            lambda_recon=a.get("lambda_recon", 1.0),
        ),
        paired=a.get("paired", False),
        device=device,
    )
    load_checkpoint(task, run["checkpoint"])
    return task


def build_test_loader(args_dict: Dict, data_dir: str, batch_size: int = 1,
                      max_samples: Optional[int] = None):
    """Deterministic test data (Resize only; reference test.py:145-281)."""
    dataset_name = args_dict["dataset"]
    image_size = args_dict.get("image_size", 256)
    aug = AugmentConfig(out_size=image_size, hflip_p=0.0, random_crop=False)
    if dataset_name == "maps":
        ds = SatelliteMapDataset(str(Path(data_dir) / "maps"), "val", augment=aug)
    elif dataset_name == "summer2winter":
        ds = Summer2WinterDataset(
            str(Path(data_dir) / "summer2winter"), "test", augment=aug
        )
    else:
        full = HypersimDataset(
            str(Path(data_dir) / "hypersim"),
            [args_dict["source_modality"], args_dict["target_modality"]],
            augment=aug,
            paired_mode=True,
        )
        # seeded split 42, matching train.py's split (reference test.py:193-196)
        _, ds = split_dataset(full, args_dict.get("test_split", 0.1), seed=42)
    if max_samples is not None and len(ds) > max_samples:
        ds = Subset(ds, list(range(max_samples)))
    return DataLoader(ds, batch_size, shuffle=False, num_workers=4)


def save_comparison_figure(sample_idx: int, x, y, outputs: Dict[str, np.ndarray],
                           out_path: Path) -> None:
    """Per-sample figure: input/target row + one row per model
    (reference test.py:345-400)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = sorted(outputs)
    cols = 2 + len(names)
    fig, axes = plt.subplots(1, cols, figsize=(3 * cols, 3.2))
    panels = [("input x", x), ("target y", y)] + [
        (n, outputs[n]) for n in names
    ]
    for ax, (title, img) in zip(np.atleast_1d(axes), panels):
        ax.imshow(np.clip(img, 0, 1))
        ax.set_title(title, fontsize=8)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def save_model_grid(name: str, rows: List[Dict[str, np.ndarray]],
                    out_path: Path) -> None:
    """Per-model grid: each row = (x, Gx, y) (reference test.py:403-454)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(rows)
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
    for i, row in enumerate(rows):
        for j, key in enumerate(("x", "Gx", "y")):
            axes[i][j].imshow(np.clip(row[key], 0, 1))
            axes[i][j].axis("off")
            if i == 0:
                axes[i][j].set_title(("input", name, "target")[j], fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def group_metrics(models: Dict[str, object], loader) -> Dict:
    """Every model's Gx on every sample of `loader` (batch size 1), with
    the per-model means over the samples: {"num_samples", "l1_to_target",
    "psnr_to_target", "ssim_to_target", "grids" (per model, one {x, Gx, y}
    row per sample)}."""
    l1_sums = {n: 0.0 for n in models}
    psnr_sums = {n: 0.0 for n in models}
    ssim_sums = {n: 0.0 for n in models}
    grids: Dict[str, List[Dict[str, np.ndarray]]] = {n: [] for n in models}
    n_s = 0
    for i, batch in enumerate(loader):
        batch = normalize_batch_keys(batch)
        x, y = batch["x"][0], batch["y"][0]
        for name, task in models.items():
            gx = run_inference(task, batch, seed=i)[0]
            l1_sums[name] += float(np.mean(np.abs(gx - y)))
            gxc = np.clip(gx, 0.0, 1.0)
            psnr_sums[name] += metrics.psnr(gxc, y)
            ssim_sums[name] += metrics.ssim(gxc, y)
            grids[name].append({"x": x, "Gx": gx, "y": y})
        n_s += 1
    out = {"num_samples": n_s, "l1_to_target": {}, "psnr_to_target": {},
           "ssim_to_target": {}, "grids": grids}
    if n_s:
        for name in models:
            out["l1_to_target"][name] = l1_sums[name] / n_s
            out["psnr_to_target"][name] = psnr_sums[name] / n_s
            out["ssim_to_target"][name] = ssim_sums[name] / n_s
    return out


def evaluate_model_group(dataset_name: str, runs: List[Dict], args) -> None:
    """Group runs by modality pair, compare on shared samples, write figures
    + summary.json (reference test.py:470-604)."""
    device = device_for(getattr(args, "platform", None))
    by_modality: Dict[str, List[Dict]] = {}
    for run in runs:
        key = (f"{run['args'].get('source_modality')}_to_"
               f"{run['args'].get('target_modality')}")
        by_modality.setdefault(key, []).append(run)

    out_root = Path(args.output_dir) / dataset_name
    for mod_key, group in by_modality.items():
        out_dir = out_root / mod_key
        out_dir.mkdir(parents=True, exist_ok=True)
        print(f"\nEvaluating group {dataset_name}/{mod_key}: "
              f"{len(group)} run(s)")

        models = {}
        run_by_name = {}
        for run in group:
            try:
                models[run["name"]] = load_model_for_inference(run, device)
                run_by_name[run["name"]] = run
            except Exception as e:  # noqa: BLE001
                print(f"  skipping {run['name']}: {e}")
        if not models:
            continue

        loader = build_test_loader(group[0]["args"], args.data_dir,
                                   batch_size=1, max_samples=args.num_samples)
        try:
            result = group_metrics(models, loader)
        finally:
            loader.close()
        ref_args = group[0]["args"]
        summary = {
            "dataset": dataset_name,
            # reference summary fields, field-for-field (test.py:583-599)
            "modality": mod_key,
            "modality_key": mod_key,
            "source_modality": ref_args.get("source_modality"),
            "target_modality": ref_args.get("target_modality"),
            "num_models": len(models),
            "unpaired": not ref_args.get("paired", False),
            # per-model metadata: name/architecture/checkpoint/training_args
            "models": [
                {
                    "name": name,
                    "architecture": run_by_name[name]["args"].get(
                        "architecture"),
                    "checkpoint": str(run_by_name[name]["checkpoint"]),
                    "training_args": run_by_name[name]["args"],
                }
                for name in sorted(models)
            ],
            "num_samples": result["num_samples"],
            "l1_to_target": result["l1_to_target"],
            # beyond reference parity: the reference compares models only
            # visually; we also report PSNR/SSIM against the target
            "psnr_to_target": result["psnr_to_target"],
            "ssim_to_target": result["ssim_to_target"],
        }

        # figure count is capped independently of the metric sample count
        # (reference test.py:714-715: --num_comparison_figures, default 10
        # — metrics still average over all num_samples)
        n_figs = getattr(args, "num_comparison_figures", None)
        grids = result["grids"]
        rows = next(iter(grids.values()))
        for i in range(len(rows) if n_figs is None
                       else min(n_figs, len(rows))):
            save_comparison_figure(
                i, rows[i]["x"], rows[i]["y"],
                {name: grids[name][i]["Gx"] for name in models},
                out_dir / f"comparison_sample_{i:03d}.png",
            )
        for name in models:
            save_model_grid(name, grids[name], out_dir / f"grid_{name}.png")

        if getattr(args, "fid", False) and summary["num_samples"]:
            # beyond parity: FID of each model's outputs vs the targets
            from vae_cyclegan_tpu_torch.utils import fid as fid_mod

            feature_fn = fid_mod.make_feature_fn(
                fid_mod.load_torch_inception(args.fid_weights, device))
            targets = [row["y"] for row in next(iter(grids.values()))]
            summary["fid_to_target"] = {
                name: fid_mod.fid_score(
                    [row["Gx"] for row in grids[name]], targets, feature_fn
                )
                for name in models
            }

        with open(out_dir / "summary.json", "w") as f:
            json.dump(summary, f, indent=2)
        n_figs_written = summary["num_samples"] if n_figs is None \
            else min(n_figs, summary["num_samples"])
        print(f"  wrote {n_figs_written} comparison figure(s) over "
              f"{summary['num_samples']} sample(s) + summary.json to "
              f"{out_dir}")


def evaluate_models(args) -> None:
    runs = discover_runs(args.runs_dir)
    # reference filter surface (test.py:706-711): --architectures keeps
    # only the named model families; --dataset_filter keeps only runs
    # trained on that dataset
    arch_filter = getattr(args, "architectures", None)
    if arch_filter:
        runs = [r for r in runs
                if r["args"].get("architecture") in set(arch_filter)]
        print(f"Architecture filter {sorted(set(arch_filter))}: "
              f"{len(runs)} run(s) kept")
    ds_filter = getattr(args, "dataset_filter", None)
    if ds_filter:
        runs = [r for r in runs
                if r["args"].get("dataset", "hypersim") == ds_filter]
        print(f"Dataset filter {ds_filter!r}: {len(runs)} run(s) kept")
    if not runs:
        print("No completed runs found.")
        return
    by_dataset: Dict[str, List[Dict]] = {}
    for run in runs:
        by_dataset.setdefault(run["args"].get("dataset", "hypersim"), []).append(run)
    for dataset_name, group in by_dataset.items():
        evaluate_model_group(dataset_name, group, args)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate and compare trained models (PyTorch/CUDA port)"
    )
    parser.add_argument("--runs_dir", type=str, default="runs")
    parser.add_argument("--data_dir", type=str, default="dataset")
    parser.add_argument("--output_dir", type=str, default="test_results")
    parser.add_argument("--num_samples", type=int, default=8,
                        help="Test samples per comparison group")
    # Filter options (reference test.py:706-711)
    parser.add_argument("--architectures", type=str, nargs="+", default=None,
                        help="Filter to specific architectures "
                             "(e.g. autoencoder vae aegan)")
    parser.add_argument("--dataset_filter", type=str, default=None,
                        choices=["hypersim", "summer2winter", "maps"],
                        help="Only evaluate models trained on this dataset")
    parser.add_argument("--num_comparison_figures", type=int, default=10,
                        help="Max side-by-side comparison figures to write "
                             "(metrics still average over --num_samples; "
                             "reference test.py:714-715)")
    parser.add_argument("--fid", action="store_true",
                        help="also report FID vs targets (needs "
                             "--fid_weights)")
    parser.add_argument("--fid_weights", type=str, default=None,
                        help="torchvision inception_v3 state_dict (.pth) "
                             "or .npz with the same keys; FID matches "
                             "standard pytorch-fid scoring when given the "
                             "ImageNet checkpoint")
    parser.add_argument("--platform", type=str, default=None,
                        help="cuda (the default: the card) or cpu")
    return parser


def main(args) -> None:
    if args.fid and not args.fid_weights:
        raise ValueError("--fid requires --fid_weights (torchvision "
                         "inception_v3 checkpoint; not bundled)")
    device = device_for(args.platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (the driver runs on the card by "
                           "default); pass --platform cpu to run on the CPU")
    evaluate_models(args)


if __name__ == "__main__":
    main(build_parser().parse_args())
