"""The port's serving entry point takes the batches the JAX package's
``test.py`` takes: ``normalize_batch_keys`` against ``test.py``'s own on the
legacy and modern batches of tests/test_cli.py, and ``run_inference`` on a
legacy 'A' batch against the same images keyed 'x'. CPU, tiny task."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.inference import normalize_batch_keys, run_inference
from vae_cyclegan_tpu_torch.models.tasks import create_task


@pytest.fixture(scope="module")
def jax_normalize():
    spec = importlib.util.spec_from_file_location(
        "eval_driver", Path(__file__).resolve().parents[1] / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.normalize_batch_keys


A = np.zeros((1, 4, 4, 3), np.float32)
B = np.ones((1, 4, 4, 3), np.float32)
# tests/test_cli.py's cases, and an extra key beside the legacy ones
BATCHES = {"A+B": {"A": A, "B": B}, "A": {"A": A},
           "modern": {"x": A, "y": B},
           "A+B+extra": {"A": A, "B": B, "path": np.array(["a.png"])}}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_normalize_batch_keys_matches_test_py(jax_normalize, case):
    batch = BATCHES[case]
    got, want = normalize_batch_keys(batch), jax_normalize(batch)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    # a modern batch passes through as the same object on both sides
    assert (got is batch) == (want is batch)


@pytest.mark.parametrize("name", ["autoencoder", "cyclevaegan"])
def test_run_inference_takes_legacy_batch(name):
    task = create_task(name, model=ModelConfig(32, 8, 8), device="cpu")
    task.init(0)
    a = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    want = run_inference(task, {"x": a}, seed=3)
    for batch in ({"A": a}, {"A": a, "B": a[::-1].copy()}):
        np.testing.assert_array_equal(run_inference(task, batch, seed=3), want)
    assert want.shape == a.shape and np.isfinite(want).all()
