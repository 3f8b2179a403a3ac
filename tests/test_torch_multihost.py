"""``--multihost`` on the CPU: two processes of a group that a torchrun-style
environment describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT on the loopback address), over gloo. The counterpart of
tests/test_parallel.py:400 (two ``jax.distributed`` processes).

* Each process loads its slice of every global batch (the loader's
  ``shard_index``/``shard_count``, JAX's multi-host drop rule); gathered in
  rank order the slices are exactly the one-process loader's global batch
  stream (the same global positions, so the same augmentation draws).
* The driver: ``python -m vae_cyclegan_tpu_torch.train --multihost`` in
  both processes trains an epoch; rank 0 alone writes the run directory.

Each process imports torch and the port only. Small size: image 32, base
8, latent 8, batch 2 (one sample a rank).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
from PIL import Image

from vae_cyclegan_tpu_torch.parallel import mesh

REPO = Path(__file__).resolve().parents[1]

_LOADER_WORKER = r'''
import numpy as np, torch, torch.distributed as dist
from vae_cyclegan_tpu_torch.data.loader import DataLoader
from vae_cyclegan_tpu_torch.parallel import mesh

device = mesh.init_from_env("cpu")
rank, world = dist.get_rank(), dist.get_world_size()
assert (rank, world, device.type) == (mesh.rank(), 2, "cpu")


class ArrDS:
    """Content depends on (index, per-position rng): a wrong shard or a
    wrong global position shows."""

    def __len__(self):
        return 18

    def get(self, idx, rng):
        v = np.full((4, 4, 3), float(idx), np.float32) + rng.random()
        return {"x": v, "y": v + 100.0}


local = DataLoader(ArrDS(), batch_size=8, shuffle=True, seed=5, num_workers=1,
                   shard_index=rank, shard_count=world)
got = []
for b in local:
    assert b["x"].shape[0] == 4  # this rank's slice of a global batch of 8
    parts = [torch.empty(4, 4, 4, 3) for _ in range(world)]
    dist.all_gather(parts, torch.from_numpy(b["x"]))
    got.append(torch.cat(parts).numpy())
# the partial final batch (2 of 18) is dropped on every rank
ref = [b["x"] for b in DataLoader(ArrDS(), batch_size=8, shuffle=True,
                                  seed=5, num_workers=1)]
assert len(got) == 2 and len(ref) == 3 and ref[2].shape[0] == 2
for a, b in zip(got, ref):
    np.testing.assert_array_equal(a, b)
assert local.replicated_batches() == [False, False]
dist.destroy_process_group()
print(f"MULTIHOST_OK {rank}", flush=True)
'''


def _launch(argv, world=2, timeout=300):
    """(exit code, stdout, stderr) of `world` processes of `argv`, each with
    the environment torchrun gives its rank."""
    port = str(mesh.free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONSTARTUP", "JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=port, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, *argv], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
        for r in range(world)]
    return [(p.returncode, *out) for p, out in
            ((p, p.communicate(timeout=timeout)) for p in procs)]


def test_multihost_two_process_batch_assembly():
    for rank, (rc, out, err) in enumerate(_launch(["-c", _LOADER_WORKER])):
        assert rc == 0, f"process {rank} failed:\n{out}{err}"
        assert f"MULTIHOST_OK {rank}" in out


def test_multihost_driver_trains_an_epoch(tmp_path):
    """Two --multihost driver processes: one run directory, written by rank
    0 (args.json, the checkpoints, one TensorBoard event file); rank 1
    prints nothing."""
    rng = np.random.RandomState(0)
    for scene in ("ai_001_001_indoor", "ai_001_002_outdoor"):
        d = tmp_path / "data" / "hypersim" / scene / "cam_00"
        d.mkdir(parents=True)
        for frame in range(4):
            for mod in ("depth", "normal"):
                Image.fromarray((rng.rand(40, 56, 3) * 255).astype(
                    np.uint8)).save(d / f"frame_{frame:04d}_{mod}.png")
    out = tmp_path / "runs"
    results = _launch([
        "-m", "vae_cyclegan_tpu_torch.train", "--platform", "cpu",
        "--multihost", "--architecture", "autoencoder", "--paired",
        "--data_dir", str(tmp_path / "data"), "--source_modality", "depth",
        "--target_modality", "depth", "--image_size", "32", "--base_width",
        "8", "--latent_dim", "8", "--batch_size", "2", "--epochs", "1",
        "--test_split", "0.5", "--output_dir", str(out), "--save_freq", "1",
        "--log_image_freq", "1", "--quiet", "--num_workers", "1"])
    for rank, (rc, text, err) in enumerate(results):
        assert rc == 0, f"process {rank} failed:\n{text}{err}"
    assert "Training completed" in results[0][1]
    assert "rank 0 of 2" in results[0][1]
    assert results[1][1].strip() == ""
    (run_dir,) = out.iterdir()
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "args.json", "best_model", "checkpoint_epoch_1", "tensorboard"]
    assert len(list((run_dir / "tensorboard").glob("events.out.*"))) == 1
    assert json.loads((run_dir / "args.json").read_text())["multihost"]
