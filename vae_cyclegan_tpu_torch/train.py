"""Training CLI for all 10 architectures on the card.

    python -m vae_cyclegan_tpu_torch.train --architecture cyclevaegan ...

Counterpart of the JAX package's ``train.py``, with its flags, defaults and
checks, its run-directory name and layout (``args.json``,
``checkpoint_epoch_N/``, ``best_model/``, ``checkpoint_preempt/``,
``tensorboard/``), its TensorBoard tag schema and its save and best-model
cadence. A checkpoint directory holds ``meta.json`` and the reference's
``.pth`` dict (``utils/checkpoint.py``).

The run is on the card unless ``--platform cpu`` asks for the CPU; without
a CUDA device the task raises. The JAX flags map as follows:

  --precision bf16   the bf16 ``ModelConfig`` (parameters stay f32)
  --debug_nans       ``torch.autograd.set_detect_anomaly(True)``, the
                     reference's own toggle
  --profile_dir      a ``torch.profiler`` trace of the first epoch, written
                     for TensorBoard's profile tab
  --remat            ``ModelConfig.remat``: the generator passes
                     recomputed in the backward (``torch.utils.checkpoint``)
  --device_aug, --decode_cache, --no_nan_dump   as in the JAX driver
  --num_devices N    data parallelism on one host: the driver spawns N
                     ranks (start method ``spawn``), one device each
                     (``cuda:r``; CPU ranks over gloo with --platform cpu),
                     a ``torch.distributed`` group (``parallel.mesh``);
                     None means every visible CUDA device (one on the CPU),
                     and 1 runs in this process without a group. Asking
                     for more CUDA devices than are visible raises.
  --multihost        this process is one rank of a group ``torchrun``
                     describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
                     MASTER_PORT), on ``cuda:LOCAL_RANK``

Under either, each rank loads its slice of every global batch (the loader's
``shard_index``/``shard_count``) and the task means (loss, gradients)
across the ranks (``parallel.dp``). A global batch the ranks do not divide
is given whole to every rank under --num_devices (JAX's single-host rule,
one warning) and dropped under --multihost (JAX's multi-host rule). Only
the primary rank (rank 0) writes: the run directory, ``args.json``,
checkpoints, ``best_model/``, TensorBoard, NaN dumps and the profile; it
alone shows progress bars, and the other ranks' standard output is
silenced. Every rank reads the checkpoint it resumes from (and the
Double* checkpoint it transfers from) itself, so the path must be readable
on every host. A SIGTERM to any rank (to the launching process under
--num_devices, which passes it on) stops every rank after the same step
(``utils.preempt.AgreedStop``), and the primary saves ``checkpoint_preempt/``.

Refused, each with an error naming its ROADMAP.md item: ``--spatial`` above
1 (queue 1, item 7c: spatial parallelism, not ported yet) and
``--no_pallas`` (item 10: no switch turns the port's kernels off, and no
caller of the port needs a plain-only mode).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from datetime import datetime
from pathlib import Path

import torch
import torch.distributed as dist

from vae_cyclegan_tpu_torch.config import LossConfig, ModelConfig, OptimConfig
from vae_cyclegan_tpu_torch.data import (
    AugmentConfig,
    ColorJitterConfig,
    DataLoader,
    HypersimDataset,
    SatelliteMapDataset,
    Summer2WinterDataset,
    split_dataset,
)
from vae_cyclegan_tpu_torch.engine import Engine
from vae_cyclegan_tpu_torch.models.tasks import ARCHITECTURES, create_task
from vae_cyclegan_tpu_torch.parallel import mesh
from vae_cyclegan_tpu_torch.utils import (
    GracefulShutdown,
    checkpoint_exists,
    load_checkpoint,
    load_pretrained_doubleae_to_cycle,
    load_pretrained_doublevae_to_cycle,
    nan_dump,
    save_checkpoint,
)
from vae_cyclegan_tpu_torch.utils.preempt import AgreedStop
from vae_cyclegan_tpu_torch.utils.tb import (
    TBWriter,
    truncate_tensorboard_events,
)

DATASET_MODALITY_DEFAULTS = {
    "hypersim": ("depth", "normal"),
    "summer2winter": ("summer", "winter"),
    "maps": ("satellite", "map"),
}


def device_for(platform) -> torch.device:
    """The device of a ``--platform`` value: the card by default (None or
    "cuda"), the CPU for "cpu"; anything else raises."""
    if platform in (None, "cuda"):
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform {platform!r}: the port runs on 'cuda' (the "
                     "default) or 'cpu'")


def refuse_unported(args) -> None:
    """Raise on the JAX flags the port has no counterpart of yet."""
    waits = []
    if args.spatial > 1:
        waits.append("--spatial > 1 (ROADMAP.md queue 1, item 7c: spatial "
                     "parallelism)")
    if args.no_pallas:
        waits.append("--no_pallas (ROADMAP.md queue 1, item 10: no switch "
                     "turns the port's kernels off, and no caller of the "
                     "port needs a plain-only mode)")
    if waits:
        raise NotImplementedError("not ported: " + "; ".join(waits))


def _shard_kwargs(args) -> dict:
    """Data parallelism: each rank loads its slice of every global batch
    (the loader's shard_index/shard_count), with JAX's rule for a batch the
    ranks do not divide: replicate on one host, drop across hosts."""
    world = mesh.world_size()
    if world == 1:
        return {}
    return {"shard_index": mesh.rank(), "shard_count": world,
            "ragged": "drop" if args.multihost else "replicate"}


def create_dataloaders_hypersim(args):
    """Hypersim loaders (reference train.py:174-239): RandomHFlip .5 /
    VFlip .3 / RandomResizedCrop scale (0.33,1) bicubic; ColorJitter
    (.3,.3,.3,.15) for the color modality; images stay in [0,1]."""
    aug = AugmentConfig(out_size=args.image_size, hflip_p=0.5, vflip_p=0.3)
    device_aug = getattr(args, "device_aug", False)
    uses_color = "color" in (args.source_modality, args.target_modality)
    if device_aug and uses_color:
        raise ValueError(
            "--device_aug does not support the host-side color jitter the "
            "'color' modality requires; drop --device_aug"
        )
    dataset = HypersimDataset(
        root_dir=str(Path(args.data_dir) / "hypersim"),
        modalities=[args.source_modality, args.target_modality],
        augment=aug,
        color_jitter=(None if device_aug
                      else ColorJitterConfig(0.3, 0.3, 0.3, 0.15)),
        paired_mode=args.paired,
        uint8_output=True,
        raw_mode=device_aug,
    )
    if args.test_split > 0:
        train_ds, test_ds = split_dataset(dataset, args.test_split, seed=42)
        print(f"Training samples: {len(train_ds)}, Testing samples: {len(test_ds)}")
    else:
        train_ds, test_ds = dataset, None
        print(f"Training samples: {len(train_ds)}")
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              seed=args.seed, num_workers=args.num_workers,
                              **_shard_kwargs(args))
    test_loader = (
        DataLoader(test_ds, args.batch_size, shuffle=False,
                   num_workers=args.num_workers, **_shard_kwargs(args))
        if test_ds is not None and len(test_ds) > 0
        else None
    )
    return train_loader, test_loader


def create_dataloaders_maps(args):
    """Maps loaders (reference train.py:242-298); val split deterministic."""
    train_ds = SatelliteMapDataset(
        str(Path(args.data_dir) / "maps"), "train",
        augment=AugmentConfig(out_size=args.image_size, hflip_p=0.5),
        uint8_output=True,
    )
    test_ds = SatelliteMapDataset(
        str(Path(args.data_dir) / "maps"), "val",
        augment=AugmentConfig(out_size=args.image_size, hflip_p=0.0,
                              random_crop=False),
        uint8_output=True,
    )
    print(f"Training samples: {len(train_ds)}")
    print(f"Testing samples: {len(test_ds)}")
    return (
        DataLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed,
                   num_workers=args.num_workers, **_shard_kwargs(args)),
        DataLoader(test_ds, args.batch_size, shuffle=False,
                   num_workers=args.num_workers, **_shard_kwargs(args)),
    )


def create_dataloaders_summer2winter(args):
    """Summer2Winter loaders (reference train.py:301-357)."""
    train_ds = Summer2WinterDataset(
        str(Path(args.data_dir) / "summer2winter"), "train",
        augment=AugmentConfig(out_size=args.image_size, hflip_p=0.5),
        color_jitter=ColorJitterConfig(0.2, 0.2, 0.2, 0.1),
        uint8_output=True,
    )
    test_ds = Summer2WinterDataset(
        str(Path(args.data_dir) / "summer2winter"), "test",
        augment=AugmentConfig(out_size=args.image_size, hflip_p=0.0,
                              random_crop=False),
        uint8_output=True,
    )
    print(f"Training samples: {len(train_ds)}")
    print(f"Testing samples: {len(test_ds)}")
    return (
        DataLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed,
                   num_workers=args.num_workers, **_shard_kwargs(args)),
        DataLoader(test_ds, args.batch_size, shuffle=False,
                   num_workers=args.num_workers, **_shard_kwargs(args)),
    )


def build_task(args, device):
    """The task of `args` on `device`, with fresh weights from
    ``args.seed``."""
    mc = ModelConfig(
        image_size=args.image_size,
        latent_dim=args.latent_dim,
        base_width=args.base_width,
        dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
        remat=args.remat,
    )
    oc = OptimConfig(lr=args.lr)
    lc = LossConfig(
        lambda_kl=args.lambda_kl,
        lambda_gan=args.lambda_gan,
        lambda_identity=args.lambda_identity,
        lambda_cycle=args.lambda_cycle,
        lambda_recon=args.lambda_recon,
    )
    task = create_task(args.architecture, model=mc, optim=oc, loss=lc,
                       paired=args.paired, device=device)
    task.init(args.seed)
    return task


def _load_pretrained_state(ckpt_path: str, pretrain_arch: str, args,
                           device):
    """Restore a Double* checkpoint into its task and return its
    state_dict."""
    meta_args_path = Path(ckpt_path) / "meta.json"
    saved_args = {}
    if meta_args_path.exists():
        saved_args = json.loads(meta_args_path.read_text()).get("args", {})
    ns = argparse.Namespace(**{**vars(args), **{
        "architecture": pretrain_arch,
        "latent_dim": saved_args.get("latent_dim", args.latent_dim),
        "base_width": saved_args.get("base_width", args.base_width),
        "image_size": saved_args.get("image_size", args.image_size),
        "paired": True,
    }})
    task = build_task(ns, device)
    load_checkpoint(task, ckpt_path)
    return task.state_dict()


def main(args):
    # Good-practice checks (reference train.py:363-365)
    if args.architecture in ("autoencoder", "vae"):
        if args.source_modality is not None and args.target_modality is not None \
                and args.source_modality != args.target_modality:
            raise ValueError(
                "Source and target modalities should be the same for "
                "Autoencoder/VAE architectures."
            )

    default_source, default_target = DATASET_MODALITY_DEFAULTS[args.dataset]
    if args.source_modality is None:
        args.source_modality = default_source
    if args.target_modality is None:
        args.target_modality = default_target
    if args.architecture in ("autoencoder", "vae") and \
            args.source_modality != args.target_modality:
        raise ValueError(
            "Source and target modalities should be the same for "
            "Autoencoder/VAE architectures."
        )

    if args.dataset == "summer2winter" and args.paired:
        print("WARNING: --paired flag is ignored for summer2winter dataset "
              "(inherently unpaired)")
        args.paired = False

    refuse_unported(args)
    device = device_for(args.platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (the driver runs on the card by "
                           "default); pass --platform cpu to run on the CPU")
    if args.multihost:
        rank_device = mesh.init_from_env(device)
        try:
            return _run_rank(rank_device, args)
        finally:
            mesh.destroy()
    n = mesh.resolve_devices(args.num_devices, device)
    if n > 1:
        output_dir = (Path(args.resume).parent if args.resume
                      else _new_run_dir(args))
        print(f"Data parallelism: spawning {n} ranks on {device.type}")
        mesh.spawn(_run_rank, n, device, args, output_dir)
        return output_dir
    return _run_rank(device, args)


def _new_run_dir(args) -> Path:
    """A fresh run's directory (reference train.py:397-412)."""
    timestamp = datetime.now().strftime("%m%d_%H%M")
    return Path(args.output_dir) / (
        f"{args.architecture}_{timestamp}_{args.source_modality}_to_"
        f"{args.target_modality}_{args.dataset}")


class _NullWriter:
    """The TensorBoard writer of a rank other than the primary."""

    def add_scalar(self, *args) -> None:
        pass

    add_images = add_scalar

    def close(self) -> None:
        pass


def _run_rank(device, args, output_dir=None):
    """The run on `device`: the whole run without a group, this rank's part
    of it in one (`output_dir`: the run directory a --num_devices launcher
    named). The ranks other than the primary print nothing. Returns the run
    directory."""
    primary = mesh.is_primary()
    if not primary:
        sys.stdout = open(os.devnull, "w")
    print(f"Device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + (f", rank {mesh.rank()} of {mesh.world_size()}"
             if mesh.world_size() > 1 else ""))

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
        print("autograd anomaly detection enabled - will fail at the op "
              "producing a NaN")

    # Output dir (reference train.py:397-412)
    if args.resume:
        checkpoint_path = Path(args.resume)
        if not checkpoint_exists(checkpoint_path):
            raise FileNotFoundError(f"No checkpoint found at {checkpoint_path}")
        output_dir = checkpoint_path.parent
        print(f"Resuming run in directory: {output_dir}")
    else:
        if output_dir is None:
            output_dir = _new_run_dir(args)
            if mesh.world_size() > 1:  # the primary's name on every host
                name = [str(output_dir)]
                dist.broadcast_object_list(name, src=0,
                                           group=mesh.cpu_group())
                output_dir = Path(name[0])
        if primary:
            output_dir.mkdir(parents=True, exist_ok=True)
            with open(output_dir / "args.json", "w") as f:
                json.dump(vars(args), f, indent=2)
        print(f"Output directory: {output_dir}")

    tensorboard_dir = output_dir / "tensorboard"
    if args.resume and primary:
        meta = json.loads((Path(args.resume) / "meta.json").read_text())
        truncate_tensorboard_events(tensorboard_dir, meta["epoch"])

    if args.decode_cache:
        from vae_cyclegan_tpu_torch.data import DecodedImageCache

        cache = DecodedImageCache(args.decode_cache).attach()
        print(f"decode cache attached: {len(cache)} images")

    if args.device_aug and args.dataset != "hypersim":
        raise ValueError("--device_aug currently supports only --dataset "
                         "hypersim (raw frame sizes must be uniform)")

    # Dataloaders (reference train.py:429-437)
    if args.dataset == "maps":
        train_loader, test_loader = create_dataloaders_maps(args)
        print("Using maps dataset (satellite-to-map)")
    elif args.dataset == "summer2winter":
        train_loader, test_loader = create_dataloaders_summer2winter(args)
        print("Using Summer2Winter Yosemite dataset (unpaired)")
    else:
        train_loader, test_loader = create_dataloaders_hypersim(args)
        print(f"Using Hypersim dataset in "
              f"{'paired' if args.paired else 'unpaired'} mode")

    writer = TBWriter(tensorboard_dir) if primary else _NullWriter()
    print(f"TensorBoard logs: {tensorboard_dir}")
    # NaN observability: on a non-finite loss the step skips the update AND
    # dumps loss/batch/params/grads to the run dir (reference prints all
    # params+grads to console, Networks.py:356-372).
    if not args.no_nan_dump and primary:
        nan_dump.enable(output_dir)
    # Preemption grace: the first SIGTERM/SIGINT finishes the in-flight
    # step, saves a resumable checkpoint_preempt/ and returns; a second
    # signal aborts immediately. In a group the ranks agree on the step.
    local_stop = GracefulShutdown().install()
    stop = (AgreedStop(local_stop, mesh.cpu_group())
            if mesh.world_size() > 1 else local_stop)
    try:
        return _train(args, device, output_dir, writer, train_loader,
                      test_loader, stop)
    finally:
        local_stop.uninstall()
        nan_dump.disable()
        writer.close()
        for loader in (train_loader, test_loader):
            if loader is not None:
                loader.close()


def _train(args, device, output_dir, writer, train_loader, test_loader,
           stop):
    task = build_task(args, device)
    primary = mesh.is_primary()
    progress = not args.quiet and primary
    engine = Engine(task, seed=args.seed,
                    group=dist.group.WORLD if mesh.world_size() > 1 else None)

    # Pretrained Double* -> Cycle* transfer (reference train.py:443-460)
    if args.pretrained_doubleae is not None and args.pretrained_doublevae is not None:
        raise ValueError(
            "Cannot specify both --pretrained_doubleae and --pretrained_doublevae"
        )
    if args.pretrained_doubleae is not None:
        if args.architecture not in ("cycleae", "cycleaegan"):
            raise ValueError(
                "--pretrained_doubleae can only be used with CycleAE/CycleAEGAN "
                f"architectures, not {args.architecture}"
            )
        print(f"\nInitializing {args.architecture} from pretrained DoubleAutoencoder...")
        sd = _load_pretrained_state(args.pretrained_doubleae, "doubleae",
                                    args, device)
        load_pretrained_doubleae_to_cycle(task, sd)
        print("Pretraining loaded successfully\n")
    if args.pretrained_doublevae is not None:
        if args.architecture not in ("cyclevae", "cyclevaegan"):
            raise ValueError(
                "--pretrained_doublevae can only be used with CycleVAE or "
                f"CycleVAEGAN architectures, not {args.architecture}"
            )
        print(f"\nInitializing {args.architecture} from pretrained "
              "DoubleVariationalAutoencoder...")
        sd = _load_pretrained_state(args.pretrained_doublevae, "doublevae",
                                    args, device)
        load_pretrained_doublevae_to_cycle(task, sd)
        print("Pretraining loaded successfully\n")

    # Resume (reference train.py:472-477)
    start_epoch = 0
    if args.resume:
        print(f"Resuming from checkpoint: {args.resume}")
        epoch, _, _ = load_checkpoint(task, args.resume, engine)
        start_epoch = epoch + 1

    print("Model configured with optimizers and loss functions")

    # Initial validation, console only (reference train.py:483-507)
    if test_loader is not None:
        print(f"\n{'=' * 80}\nINITIAL VALIDATION (Before Training)\n{'=' * 80}")
        loss0, comps0, *_ = engine.validate(
            test_loader, progress=progress, epoch=start_epoch)
        print(f"Initial Test Loss: {loss0:.4f}")
        for k, v in comps0.items():
            print(f"  {k}: {v:.6f}")
        print(f"{'=' * 80}\n")

    print(f"Starting training for {args.epochs} epochs...")
    best_test_loss = float("inf")

    for epoch in range(start_epoch, args.epochs):
        print(f"\nEpoch {epoch + 1}/{args.epochs}")
        train_loader.set_epoch(epoch)
        profiler = None
        if (args.profile_dir is not None and epoch == start_epoch
                and primary):
            profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA]
                   if device.type == "cuda" else []),
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    args.profile_dir))
            profiler.start()
        train_loss, train_comps, _ = engine.train_epoch(
            train_loader, progress=progress, epoch=epoch,
            should_stop=stop,
        )
        if profiler is not None:
            profiler.stop()
            print(f"Profiler trace written to {args.profile_dir}")
        if stop.requested:
            # Save as epoch-1: --resume re-runs the interrupted epoch, so
            # the epoch-indexed TB schema and save/best cadence stay exact.
            if primary:
                save_checkpoint(task, epoch - 1, train_loss, vars(args),
                                output_dir / "checkpoint_preempt", engine)
            print(f"Preemption checkpoint saved; resume with:\n  "
                  f"--resume {output_dir / 'checkpoint_preempt'}")
            return output_dir
        print(f"Train Loss: {train_loss:.4f}")
        for k, v in train_comps.items():
            print(f"  {k}: {v:.6f}")

        writer.add_scalar("Loss/train", train_loss, epoch)
        for k, v in train_comps.items():
            if k == "nan_detected" and v == 0.0:
                continue  # keep the reference's tag schema in healthy runs
            writer.add_scalar(f"Loss_Components_train/{k}", v, epoch)

        if test_loader is not None and epoch % args.log_image_freq == 0:
            test_loss, test_comps, test_Gx, test_Fy, test_x, test_y = (
                engine.validate(test_loader, progress=progress,
                                epoch=epoch + 1))
            print(f"Test Loss: {test_loss:.4f}")
            for k, v in test_comps.items():
                print(f"  {k}: {v:.6f}")
            writer.add_scalar("Loss/test", test_loss, epoch)
            for k, v in test_comps.items():
                writer.add_scalar(f"Loss_Components_test/{k}", v, epoch)

            # Images: first 4, clamped to [0,1] (reference train.py:552-563).
            # Raw (device-aug) batches carry no host-side x/y images.
            if test_x is not None:
                writer.add_images(f"{args.source_modality}/test_x",
                                  test_x[:4], epoch)
            if test_y is not None:
                writer.add_images(f"{args.target_modality}/test_y",
                                  test_y[:4], epoch)
            writer.add_images(f"{args.target_modality}/test_Gx", test_Gx[:4], epoch)
            if test_Fy is not None:
                writer.add_images(f"{args.source_modality}/test_Fy",
                                  test_Fy[:4], epoch)

            if test_loss < best_test_loss:
                best_test_loss = test_loss
                if primary:
                    save_checkpoint(task, epoch, test_loss, vars(args),
                                    output_dir / "best_model", engine)
                print(f"New best model saved (test_loss: {test_loss:.4f})")

        if (epoch + 1) % args.save_freq == 0 and primary:
            save_checkpoint(task, epoch, train_loss, vars(args),
                            output_dir / f"checkpoint_epoch_{epoch + 1}",
                            engine)

    print(f"\nTraining completed. Models saved to {output_dir}")
    print(f"TensorBoard logs : tensorboard --logdir={output_dir / 'tensorboard'}")
    return output_dir


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train VAE-CycleGAN models (PyTorch/CUDA port)")
    # Architecture selection (reference train.py:591-599)
    parser.add_argument("--architecture", type=str, default="autoencoder",
                        choices=sorted(ARCHITECTURES.keys()))
    parser.add_argument("--paired", action="store_true", default=False,
                        help="Paired training mode (translation/identity "
                             "loss). Default is unpaired (cycle loss only).")
    parser.add_argument("--unpaired", dest="paired", action="store_false",
                        help="Unpaired training mode (cycle loss only); default.")
    # Transfer learning (reference train.py:602-605)
    parser.add_argument("--pretrained_doubleae", type=str, default=None)
    parser.add_argument("--pretrained_doublevae", type=str, default=None)
    # Data (reference train.py:608-620)
    parser.add_argument("--data_dir", type=str, default="dataset")
    parser.add_argument("--source_modality", type=str, default=None)
    parser.add_argument("--target_modality", type=str, default=None)
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--test_split", type=float, default=0.1)
    parser.add_argument("--dataset", type=str, default="hypersim",
                        choices=["hypersim", "summer2winter", "maps"])
    # Training (reference train.py:623-628)
    parser.add_argument("--batch_size", type=int, default=5,
                        help="Reference default is 5")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.0002)
    # Loss weights (reference train.py:631-640)
    parser.add_argument("--lambda_kl", type=float, default=1e-5)
    parser.add_argument("--lambda_gan", type=float, default=1.0)
    parser.add_argument("--lambda_identity", type=float, default=5.0)
    parser.add_argument("--lambda_cycle", type=float, default=10.0)
    parser.add_argument("--lambda_recon", type=float, default=1.0)
    # Checkpointing/output (reference train.py:643-650)
    parser.add_argument("--output_dir", type=str, default="runs")
    parser.add_argument("--save_freq", type=int, default=10)
    parser.add_argument("--log_image_freq", type=int, default=5)
    parser.add_argument("--resume", type=str, default=None,
                        help="Path to checkpoint directory to resume from")
    # Other (reference train.py:653-656 + the JAX driver's additions)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--latent_dim", type=int, default=64,
                        help="VAE latent channels (README gap fix)")
    parser.add_argument("--base_width", type=int, default=64)
    parser.add_argument("--precision", choices=["float32", "bf16"],
                        default="float32")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Data-parallel ranks on this host, one device "
                             "each (default: every visible CUDA device; "
                             "CPU ranks over gloo with --platform cpu)")
    parser.add_argument("--spatial", type=int, default=1,
                        help="Spatial-parallel axis size: not ported above "
                             "1 (ROADMAP.md queue 1, item 7c)")
    parser.add_argument("--remat", action="store_true",
                        help="Rematerialize generator forwards "
                             "(torch.utils.checkpoint) to fit device memory")
    parser.add_argument("--no_pallas", action="store_true",
                        help="Turn the kernels off: refused, no caller of "
                             "the port needs a plain-only mode (ROADMAP.md "
                             "queue 1, item 10)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quiet", action="store_true",
                        help="Disable progress bars")
    # Observability (reference has only a hard-coded-off anomaly toggle,
    # train.py:391-394)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Capture a torch.profiler trace of the first "
                             "epoch into this dir (view with TensorBoard's "
                             "profile tab)")
    parser.add_argument("--no_nan_dump", action="store_true",
                        help="Disable writing loss/batch/params/grads dumps "
                             "to <run_dir>/nan_dumps on non-finite losses")
    parser.add_argument("--platform", type=str, default=None,
                        help="cuda (the default: the card) or cpu")
    # Host-pipeline scaling (data.device_aug / data.cache)
    parser.add_argument("--device_aug", action="store_true",
                        help="Ship full uint8 frames and run crop/flip/"
                             "resize on the card (hypersim only; host then "
                             "only decodes)")
    parser.add_argument("--decode_cache", type=str, default=None,
                        help="Path to a decoded-image cache built with "
                             "`python -m vae_cyclegan_tpu_torch.data.tools "
                             "cache` (skips PNG/JPEG decode entirely)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="Enable autograd anomaly detection (fail fast "
                             "at the op that produced a NaN; slows training)")
    parser.add_argument("--multihost", action="store_true",
                        help="This process is one rank of a group torchrun "
                             "describes (RANK, WORLD_SIZE, LOCAL_RANK, "
                             "MASTER_ADDR, MASTER_PORT)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
