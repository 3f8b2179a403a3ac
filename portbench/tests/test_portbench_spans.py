"""The readers of the program's own spans (``metrics/program_spans.py`` and
the metrics on it) on a session recorded on the CPU at a tiny size, behind
a stand-in context: each reads a value in its range from as many units as
the span has, and returns None without a span, with too few units, or
without the program's span module."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.metrics import reader
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.engine import Engine
from vae_cyclegan_tpu_torch.inference import run_inference
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.utils import spans

STEPS, REQUESTS = 3, 2
TRAIN = ["dispatch_cpu_share.train", "host_cores_busy.train",
         "forward_host_ms.train", "backward_host_ms.train",
         "optimizer_host_ms.train", "gate_wait_ms.train",
         "vct_op_host_us.train"]
SERVE = ["generate_host_ms.serve", "result_wait_ms.serve"]


def _ctx(units):
    return SimpleNamespace(span=SimpleNamespace(units=units))


@pytest.fixture(scope="module")
def session():
    """A profiled session of STEPS cyclevaegan steps and REQUESTS requests
    (image 32, base 8, latent 8, batch 2)."""
    task = create_task("cyclevaegan", model=ModelConfig(32, 8, 8),
                       paired=False, device="cpu")
    task.init(0)
    rng = np.random.RandomState(0)
    batches = [{k: rng.rand(2, 32, 32, 3).astype(np.float32)
                for k in ("x", "y")} for _ in range(STEPS)]
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        Engine(task).train_epoch(batches, progress=False)
        for i in range(REQUESTS):
            run_inference(task, batches[i], seed=i)
    yield
    spans.reset()


@pytest.mark.parametrize("metric", TRAIN + SERVE)
def test_reader_reads_the_session(session, metric):
    value = reader(metric)(_ctx(STEPS if metric in TRAIN else REQUESTS))
    assert value is not None and value >= 0
    if metric == "dispatch_cpu_share.train":
        assert 0 < value <= 101  # thread CPU against wall, clock grains
    if metric == "host_cores_busy.train":
        assert value <= os.cpu_count()
    if metric in ("backward_host_ms.train", "generate_host_ms.serve",
                  "vct_op_host_us.train"):
        assert value > 0


@pytest.mark.parametrize("metric", TRAIN + SERVE)
def test_reader_without_enough_units_reads_nothing(session, metric,
                                                   monkeypatch):
    have = STEPS if metric in TRAIN else REQUESTS
    read = reader(metric)
    assert read(SimpleNamespace(span=None)) is None
    assert read(_ctx(have + 1)) is None
    monkeypatch.setitem(sys.modules, "vae_cyclegan_tpu_torch.utils.spans",
                        None)
    assert read(_ctx(have)) is None


def test_first_units_are_the_first_session(session):
    """A second session's units are not read: the readers take the first
    ``span.units`` units."""
    before = reader("backward_host_ms.train")(_ctx(1))
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.unit("vct.step"):
            pass
    assert reader("backward_host_ms.train")(_ctx(1)) == before
    assert torch.autograd.profiler._is_profiler_enabled is False
