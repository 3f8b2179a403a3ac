"""Convert a reference PyTorch ``.pth`` checkpoint into the port's run
layout, so a reference training run can be evaluated, exported or resumed
with the port.

    python -m vae_cyclegan_tpu_torch.import_checkpoint \\
        --pth /path/to/best_model.pth --architecture cyclevaegan \\
        --out runs/imported_run [--image_size 256 --latent_dim 64] \\
        [--fresh_optimizer] [--platform cpu]

Counterpart of ``scripts/import_torch_checkpoint.py``, with its flags, plus
``--base_width`` (64, the reference's; the port's small runs use less) and
``--platform`` (the task is built on the card unless it says cpu). The
reference's ``.pth`` dict (``model_state_dict``, ``optimizer_states``,
``epoch``, ``loss``, ``args``) is the port's own checkpoint layout, so the
weights load into the task strictly under their reference keys, and each
Adam's state dict is imported unless ``--fresh_optimizer`` is given (a
never-stepped optimizer has none to import). Writes ``<out>/args.json`` and
``<out>/best_model/`` (``utils/checkpoint.py``), which the port's ``test``
discovers.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.train import device_for
from vae_cyclegan_tpu_torch.utils import save_checkpoint


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pth", required=True,
                        help="reference checkpoint (.pth)")
    parser.add_argument("--architecture", required=True)
    parser.add_argument("--out", required=True, help="output run directory")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--latent_dim", type=int, default=64)
    parser.add_argument("--base_width", type=int, default=64)
    parser.add_argument("--paired", action="store_true", default=False)
    parser.add_argument("--dataset", default="hypersim")
    parser.add_argument("--source_modality", default="depth")
    parser.add_argument("--target_modality", default="normal")
    parser.add_argument("--fresh_optimizer", action="store_true",
                        default=False,
                        help="skip importing the checkpoint's Adam moments "
                             "(by default they are imported so resumed "
                             "training keeps its momentum)")
    parser.add_argument("--platform", type=str, default=None,
                        help="the device of the task: the card by default, "
                             "cpu for the CPU")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_for(args.platform)
    # the reference's own checkpoint, as the JAX script reads it: its args
    # may be a pickled object, not only tensors
    ckpt = torch.load(args.pth, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    epoch = int(ckpt.get("epoch", 0))
    loss = float(ckpt.get("loss", 0.0))
    ref_args = ckpt.get("args", {})
    if not isinstance(ref_args, dict):
        ref_args = vars(ref_args)

    paired = args.paired or bool(ref_args.get("paired", False))
    task = create_task(args.architecture, model=ModelConfig(
        image_size=args.image_size, latent_dim=args.latent_dim,
        base_width=args.base_width), paired=paired, device=device)
    task.load_state_dict(sd, strict=True)
    opt_states = ckpt.get("optimizer_states")
    # torch Adam fills its state lazily: never-stepped optimizers have
    # nothing to import
    if opt_states and not all(v.get("state") for v in opt_states.values()):
        opt_states = None
    if opt_states and not args.fresh_optimizer:
        optimizers = task.optimizers()
        if set(opt_states) != set(optimizers):
            raise KeyError(f"{args.pth}: optimizer states "
                           f"{sorted(opt_states)}, {args.architecture} has "
                           f"{sorted(optimizers)}")
        for key, opt in optimizers.items():
            opt.load_state_dict(opt_states[key])
        print("imported Adam moments from the reference optimizer states")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    run_args = {
        "architecture": args.architecture,
        "image_size": args.image_size,
        "latent_dim": args.latent_dim,
        "base_width": args.base_width,
        "paired": args.paired,
        "dataset": ref_args.get("dataset", args.dataset),
        "source_modality": ref_args.get("source_modality",
                                        args.source_modality),
        "target_modality": ref_args.get("target_modality",
                                        args.target_modality),
        "imported_from": str(args.pth),
    }
    with open(out / "args.json", "w") as f:
        json.dump(run_args, f, indent=2)
    save_checkpoint(task, epoch, loss, run_args, out / "best_model")
    print(f"imported {args.pth} -> {out} (epoch {epoch}, loss {loss:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
