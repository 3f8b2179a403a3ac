"""The port's NaN dumps, preemption, TensorBoard truncation and image
metrics against the JAX package (vae_cyclegan_tpu_torch/utils/).

* NaN dumps: a NaN batch through the port's train_step and JAX's, with
  ``nan_dump.enable`` on both sides: both skip the update; dump by dump they
  hold the same batch arrays, a non-finite loss and as many parameter and
  gradient entries; at most 3 dumps are written.
* ``GracefulShutdown``: the cases of tests/test_preempt.py, the epoch stop
  against the port's ``Engine``.
* ``truncate_tensorboard_events``: the port's and JAX's keep the same
  events.
* ``psnr`` and ``ssim``: bit for bit JAX's on seeded arrays.
"""

import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu.utils import metrics as jax_metrics
from vae_cyclegan_tpu.utils import nan_dump as jax_nan_dump
from vae_cyclegan_tpu.utils import tb as jax_tb
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.engine import Engine
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.utils import GracefulShutdown, metrics, nan_dump, tb
from vae_cyclegan_tpu_torch.utils.jax_import import params_from_jax

IMAGE, BASE, LATENT, BATCH = 32, 8, 8, 2


def _nan_batch():
    rng = np.random.RandomState(0)
    batch = {k: rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
             for k in ("x", "y")}
    batch["x"][0, 3, 5, 1] = np.nan
    return batch


def _dumps(d):
    return [dict(np.load(p)) for p in sorted((d / "nan_dumps").glob("*.npz"))]


@pytest.mark.parametrize("name,steps", [("vae", 1), ("aegan", 2)])
def test_nan_dump_matches_jax(name, steps, tmp_path):
    """vae: one optimizer, one dump a step; aegan: G and D both skip, two
    dumps a step, so two steps hit the cap of 3."""
    batch = _nan_batch()
    jtask = jax_create_task(name, model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE,
        use_pallas=False))
    state = jtask.init_state(jax.random.PRNGKey(0))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    init = params_from_jax(np_tree(state.params),
                           np_tree(state.spectral) or None)
    jax_nan_dump.enable(tmp_path / "jax")
    try:
        step = jax.jit(jtask.train_step)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for _ in range(steps):
            new, jm = step(state, jb)
            jax.effects_barrier()
            assert float(jm["nan_detected"]) == 1.0
            for a, b in zip(jax.tree_util.tree_leaves(new.params),
                            jax.tree_util.tree_leaves(state.params)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            state = new
    finally:
        jax_nan_dump.disable()

    task = create_task(name, model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    task.load_state_dict(init)
    nan_dump.enable(tmp_path / "port")
    try:
        for _ in range(steps):
            m = task.train_step(batch)
            assert float(m["nan_detected"]) == 1.0
    finally:
        nan_dump.disable()
    # the update was skipped (the spectral power iteration still runs, as
    # in JAX's step)
    for k, v in task.nets.named_parameters():
        assert torch.equal(v, init[k]), k
    assert not any(opt.state for opt in task.optimizers().values())

    jd, pd = _dumps(tmp_path / "jax"), _dumps(tmp_path / "port")
    per_step = len(task.optimizers())
    assert len(jd) == len(pd) == min(3, steps * per_step)

    def count(dump, prefix, sep):
        return sum(k.startswith(prefix + sep) for k in dump)

    def kinds(dumps, sep):
        return sorted((count(d, "params", sep), count(d, "grads", sep))
                      for d in dumps)

    # JAX's host callbacks are unordered within a step (its D dump may come
    # first): compare the first step's dumps as a multiset
    assert kinds(pd[:per_step], ".") == kinds(jd[:per_step], "[")
    assert all(n > 0 for kind in kinds(pd, ".") for n in kind)
    for j, p in zip(jd, pd):
        assert not np.isfinite(j["loss"]) and not np.isfinite(p["loss"])
        for key in ("x", "y"):
            np.testing.assert_array_equal(p[f"batch.{key}"],
                                          j[f"batch['{key}']"])
        # the dumped parameters are the task's, under their state_dict names
        for k in (k for k in p if k.startswith("params.")):
            np.testing.assert_array_equal(p[k], init[k[len("params."):]])


def test_nan_dump_off_costs_nothing(tmp_path):
    """Disabled: a NaN step is skipped and writes nothing."""
    task = create_task("autoencoder", model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    task.init(0)
    assert not nan_dump.enabled()
    assert float(task.train_step(_nan_batch())["nan_detected"]) == 1.0
    assert not (tmp_path / "nan_dumps").exists()


def test_graceful_shutdown_sets_flag_once():
    gs = GracefulShutdown(signals=(signal.SIGUSR1,)).install()
    try:
        assert not gs.requested and not gs()
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.01)
        assert gs.requested and gs()
    finally:
        gs.uninstall()


def test_graceful_shutdown_second_signal_escalates():
    seen = []
    prev = signal.signal(signal.SIGUSR2, lambda *a: seen.append("prev"))
    gs = GracefulShutdown(signals=(signal.SIGUSR2,)).install()
    try:
        os.kill(os.getpid(), signal.SIGUSR2)
        time.sleep(0.01)
        assert gs.requested and not seen
        os.kill(os.getpid(), signal.SIGUSR2)
        time.sleep(0.01)
        assert seen == ["prev"]
    finally:
        gs.uninstall()
        signal.signal(signal.SIGUSR2, prev)


def test_engine_train_epoch_should_stop():
    """should_stop ends the port's epoch after the in-flight step; partial
    averages still come back finite."""
    task = create_task("autoencoder", model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    task.init(0)
    engine = Engine(task)
    rng = np.random.RandomState(0)
    batches = [{k: rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
                for k in ("x", "y")} for _ in range(6)]
    steps = 0

    def stop_after_two():
        nonlocal steps
        steps += 1
        return steps >= 2

    loss, comps, _ = engine.train_epoch(batches, progress=False,
                                        should_stop=stop_after_two)
    assert steps == 2
    assert np.isfinite(loss)
    assert comps["nan_detected"] == 0.0


def _events(d):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    ea = EventAccumulator(str(d), size_guidance={"scalars": 0, "images": 0})
    ea.Reload()
    scalars = {t: [(e.step, e.value) for e in ea.Scalars(t)]
               for t in ea.Tags()["scalars"]}
    images = {t: [(e.step, e.encoded_image_string) for e in ea.Images(t)]
              for t in ea.Tags()["images"]}
    return scalars, images


def test_truncate_tensorboard_events_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.rand(4, 2, 8, 8, 3).astype(np.float32)
    for side, mod in (("port", tb), ("jax", jax_tb)):
        w = mod.TBWriter(tmp_path / side)
        for step in range(4):
            w.add_scalar("Loss/train", 1.0 / (step + 1), step)
            w.add_scalar("Loss_Components_train/loss_kl", step * 0.5, step)
            w.add_images("depth/test_Gx", imgs[step], step)
        w.close()
        mod.truncate_tensorboard_events(tmp_path / side, 1)
    port, want = _events(tmp_path / "port"), _events(tmp_path / "jax")
    assert port == want
    scalars, images = port
    assert scalars["Loss/train"] == [(0, 1.0), (1, 0.5)]
    assert [s for s, _ in images["depth/test_Gx"]] == [0, 1]
    # an empty directory is left alone
    tb.truncate_tensorboard_events(tmp_path / "empty", 3)


@pytest.mark.parametrize("shape", [(48, 48, 3), (24, 40), (11, 11, 1)])
def test_psnr_ssim_match_jax(shape):
    rng = np.random.RandomState(sum(shape))
    a = rng.rand(*shape)
    for b in (np.clip(a + rng.randn(*shape) * 0.05, 0, 1),
              rng.rand(*shape).astype(np.float32), a):
        assert metrics.psnr(a, b) == jax_metrics.psnr(a, b)
        assert metrics.ssim(a, b) == jax_metrics.ssim(a, b)
    assert metrics.psnr(a, a) == metrics.PSNR_CAP_DB == jax_metrics.PSNR_CAP_DB
