"""Export a trained run's generator as a serialized serving program.

    python -m vae_cyclegan_tpu_torch.export --run_dir runs/<run> \\
        --out model.pt2 [--batch N] [--platforms cuda] [--platform cpu]

Counterpart of ``scripts/export_model.py``. Loads the run as the port's
``test`` does (``args.json`` + ``best_model/``, through
``test.load_model_for_inference``) on the card, or on the CPU with
``--platform cpu``, and writes a ``torch.export`` program
(``utils/export.py``): weights carried in it, the batch symbolic unless
``--batch`` is given, the serving signature ``(x: f32[b,S,S,3], eps) ->
f32[b,S,S,3]`` with the hand kernels as ``vct::*`` operators (they stay
on: no flag turns them off). Reload with
``vae_cyclegan_tpu_torch.utils.export.load(path)(x, seed)``; no model code
or checkpoint is needed there, only the port's ``kernels.ops``.

A program's weights live on one device, the one it was exported on, so
``--platforms`` may name only that one (``cuda`` by default, ``cpu`` with
``--platform cpu``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from vae_cyclegan_tpu_torch.train import device_for


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", required=True,
                   help="A run directory containing args.json + best_model/")
    p.add_argument("--out", required=True, help="Output program path")
    p.add_argument("--batch", type=int, default=None,
                   help="Fix the batch dimension (default: symbolic, one "
                        "program serves any batch size)")
    p.add_argument("--platforms", type=str, default=None,
                   help="Comma-separated devices the program must serve on; "
                        "only the export device (default: that device)")
    p.add_argument("--platform", type=str, default=None,
                   help="The device to export on: the card by default, cpu "
                        "for the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_for(args.platform)
    platforms = args.platforms.split(",") if args.platforms else [device.type]
    if platforms != [device.type]:
        raise SystemExit(f"--platforms {args.platforms}: a program's weights "
                         f"live on the device it was exported on "
                         f"({device.type})")

    from vae_cyclegan_tpu_torch.test import load_model_for_inference
    from vae_cyclegan_tpu_torch.utils import export as export_mod

    run_dir = Path(args.run_dir)
    args_file = run_dir / "args.json"
    if not args_file.exists():
        raise SystemExit(f"no args.json in {run_dir}")
    run = {
        "run_dir": run_dir,
        "name": run_dir.name,
        "args": json.loads(args_file.read_text()),
        "checkpoint": run_dir / "best_model",
    }
    task = load_model_for_inference(run, device=device)
    program = export_mod.export_generator(task, batch_size=args.batch)
    export_mod.save(program, args.out)
    size_mb = Path(args.out).stat().st_size / 1e6
    print(f"exported {run['args']['architecture']} generator "
          f"({task.mc.image_size}x{task.mc.image_size}, batch "
          f"{'symbolic' if args.batch is None else args.batch}, platforms "
          f"{platforms}) -> {args.out} ({size_mb:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
