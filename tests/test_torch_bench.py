"""The port's bench (``python -m vae_cyclegan_tpu_torch.bench``) on the CPU:
one JSON line with root bench.py's keys and the port's own, the refusal of
bench.py's switches the port does not have, and the kernel launches per
step that chip_smoke.py holds the card's run to.

On the CPU (``BENCH_DEVICE=cpu``) the kernels' plain versions run, so the
launch counts read 0 and the step times are host-clock times of the CPU;
the test holds the keys and the control flow, never the numbers.
"""

import json
import os
import subprocess
import sys
from collections import Counter

import jax
import pytest
import torch

from torch_families import head_dx, jax_kernel_sites, port_train_sites
from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu_torch import bench
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.models.tasks import create_task

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a tiny run of every phase: image 32, batch 1, one step per window
TINY = {"BENCH_DEVICE": "cpu", "BENCH_IMAGE_SIZE": "32", "BENCH_BATCH": "1",
        "BENCH_STEPS": "1", "BENCH_E2E_STEPS": "1", "BENCH_LOADER_STEPS": "1",
        "BENCH_LOADER_WORKERS": "1"}
# root bench.py's keys (its step-time percentiles aside), and the port's own
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "step_time_ms_window_mean", "e2e_loader_images_per_sec",
              "e2e_breakdown", "e2e_config", "loader_only_images_per_sec",
              "h2d_bandwidth_mb_s"}
PORT_KEYS = {"device", "syncs_per_step", "launches_per_step", "unified",
             "spatial", "h2d_pinned_mb_s", "h2d_pageable_mb_s"}
PHASE_KEYS = {"host_ms_per_batch", "h2d_wait_ms_per_batch",
              "dispatch_ms_per_batch", "final_sync_ms", "window_ms_per_batch"}


def run_bench(env: dict, timeout: float = 300):
    """(exit code, the parsed lines of stdout) of one bench process."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_") and k != "PYTHONSTARTUP"}
    # two torch threads: the test workers share the machine's cores
    full.update({"OMP_NUM_THREADS": "2"}, **env)
    proc = subprocess.run(
        [sys.executable, "-m", "vae_cyclegan_tpu_torch.bench"], cwd=ROOT,
        env=full, capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.strip()]
    return proc.returncode, lines, proc.stderr


def test_bench_on_the_cpu_prints_one_json_line():
    """Every phase at a tiny size (autoencoder, the e2e phase on the raw
    wire with the port's device_aug): exit 0, one line, bench.py's keys and
    the port's, no error key, positive rates, the device named as the CPU,
    no device bandwidth claimed."""
    rc, lines, err = run_bench({**TINY, "BENCH_ARCH": "autoencoder",
                                "BENCH_E2E_MODE": "device"})
    assert rc == 0, err
    assert len(lines) == 1
    out = lines[0]
    assert BENCH_KEYS | PORT_KEYS <= set(out)
    assert not [k for k in out if k.endswith("_error")], out
    assert out["metric"].startswith("autoencoder 32x32 train images/sec")
    assert out["unit"] == "images/sec" and out["value"] > 0
    assert out["vs_baseline"] > 0
    assert out["device"] == "cpu"
    assert out["syncs_per_step"] == 1   # one optimizer
    assert out["launches_per_step"] == dict.fromkeys(
        bench.UNPAIRED_STEP_LAUNCHES, 0)  # plain versions on the CPU
    assert out["e2e_loader_images_per_sec"] > 0
    assert out["e2e_batches_per_epoch"] >= 2  # no restart on every batch
    assert set(out["e2e_breakdown"]) == PHASE_KEYS
    assert out["e2e_config"]["mode"] == "device"
    assert set(out["loader_only_images_per_sec"]) == {"1", "1_raw"}
    assert all(v > 0 for v in out["loader_only_images_per_sec"].values())
    assert out["h2d_bandwidth_mb_s"] is None
    assert out["unified"] == {"backend": "gloo", "world_size": 1}


@pytest.mark.parametrize("arch,reads", [("cyclevaegan", 2),
                                        ("autoencoder", 1)])
def test_step_counts_one_loss_read_per_optimizer(arch, reads):
    """syncs_per_step counts the step's host reads of its loss, one per
    optimizer (the default architecture's G and D: two), and the launch
    counts cover exactly the counted step (0 on the CPU, where the plain
    versions run): here on a small task (image 32, base 8)."""
    task = create_task(arch, model=ModelConfig(32, 8, 8), paired=False,
                       device="cpu")
    task.init(0)
    batch = {k: torch.rand(2, 32, 32, 3) for k in ("x", "y")}
    for fn in bench._launch_counters().values():
        fn.launches = 7
    launches, syncs = bench._one_step_counts(
        task, lambda: task.train_step(batch))
    assert syncs == reads
    assert launches == dict.fromkeys(bench.UNPAIRED_STEP_LAUNCHES, 0)
    assert "_finite_update" not in vars(task)  # the gate put back


@pytest.mark.parametrize("switch", bench.UNPORTED)
def test_unported_switch_fails_the_bench(switch):
    """bench.py's switches that the port does not have are refused, not
    ignored: the bench_error line and exit 1."""
    rc, lines, _ = run_bench({"BENCH_DEVICE": "cpu", switch: "0"})
    assert rc == 1
    assert len(lines) == 1
    assert lines[0]["metric"] == "bench_error" and lines[0]["value"] == 0.0
    assert switch in lines[0]["error"]


@pytest.mark.parametrize("unified,want", [
    ("1", {"backend": "gloo", "world_size": 1}), ("0", None)])
def test_bench_unified_runs_a_world_1_group(unified, want):
    """BENCH_UNIFIED=1 (bench.py's default) runs the step through a world-1
    process group (gloo on the CPU, NCCL on the card): the data-parallel
    path, with its all_reduce per optimizer; 0 the plain step. The line
    says which."""
    rc, lines, err = run_bench({**TINY, "BENCH_ARCH": "autoencoder",
                                "BENCH_UNIFIED": unified,
                                "BENCH_E2E": "0", "BENCH_LOADER_ONLY": "0"})
    assert rc == 0, err
    assert lines[0]["unified"] == want
    assert lines[0]["value"] > 0 and lines[0]["syncs_per_step"] == 1


@pytest.mark.parametrize("value,want", [
    ("1", {"size": 1, "lowering": "halo strips + in_stats/in_apply"}),
    ("0", None)])
def test_bench_spatial_runs_a_spatial_group_of_1(value, want):
    """BENCH_SPATIAL=1 (bench.py's SP pricing) runs the step through the
    spatial lowering at a spatial group of 1: the line says so and counts
    K2's split kernels (0 on the CPU, where the plain versions run) in
    K1's place; 0 (the default) the plain step."""
    rc, lines, err = run_bench({**TINY, "BENCH_ARCH": "autoencoder",
                                "BENCH_SPATIAL": value,
                                "BENCH_E2E": "0", "BENCH_LOADER_ONLY": "0"})
    assert rc == 0, err
    assert lines[0]["spatial"] == want
    assert lines[0]["value"] > 0 and lines[0]["syncs_per_step"] == 1
    keys = set(bench.UNPAIRED_STEP_LAUNCHES)
    if want is not None:
        keys |= {"in_stats", "in_apply"}
    assert lines[0]["launches_per_step"] == dict.fromkeys(keys, 0)


def test_bench_without_a_card_fails():
    """At its default device, the card, the bench fails without CUDA (no
    fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, lines, _ = run_bench({})
    assert rc == 1 and lines[0]["metric"] == "bench_error"
    assert "no CUDA device" in lines[0]["error"]


def test_unpaired_step_launches_match_the_sites(monkeypatch):
    """bench.UNPAIRED_STEP_LAUNCHES, which chip_smoke.py holds the card's
    bench run to, are the kernel sites of the port's unpaired cyclevaegan
    step at bench.py's size (256x256, base 64, bf16, batch 24), and those
    are the JAX package's TPU trace but for the head dx of the two passes
    whose head input is data (G(x) and F(y): the JAX trace computes it and
    drops it, the port does not)."""
    sites = port_train_sites(monkeypatch, "cyclevaegan", 24, paired=False)
    kinds = Counter(s[0] for s in sites)
    names = {"in_act": "in_act", "starved_conv": "starved_conv",
             "starved_conv_dx": "starved_conv_zero_same",
             "starved_conv_dw": "starved_conv_dw"}
    assert {names[k]: n for k, n in kinds.items()} == \
        bench.UNPAIRED_STEP_LAUNCHES
    jtask = jax_create_task("cyclevaegan", model=JModelConfig(
        image_size=256, latent_dim=64, base_width=64,
        dtype=jax.numpy.bfloat16), paired=False)
    jax_sites = jax_kernel_sites(monkeypatch, jtask, 24)
    assert Counter(jax_sites) - Counter(sites) == Counter({head_dx(24): 2})
    assert not Counter(sites) - Counter(jax_sites)
