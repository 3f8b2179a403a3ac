"""``loader_process_share.train`` on a session recorded on the CPU at a
tiny size (an autoencoder, image 32, batch 2, over a host-augmented
Summer2Winter tree): 100 where the program's loader builds its batches in
worker processes, 0 where it builds them in threads, and None where the
units hold no count of the loader's batches (a program without it)."""

from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from portbench.metrics import reader
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.data import (AugmentConfig, ColorJitterConfig,
                                         DataLoader, Summer2WinterDataset)
from vae_cyclegan_tpu_torch.data import loader as port_loader
from vae_cyclegan_tpu_torch.engine import Engine
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.utils import spans

STEPS = 3
READ = reader("loader_process_share.train")


def _ctx(units):
    return SimpleNamespace(span=SimpleNamespace(units=units))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("s2w")
    rng = np.random.RandomState(0)
    for side in ("A", "B"):
        (root / f"train{side}").mkdir()
        for i in range(2 * STEPS):
            Image.fromarray((rng.rand(40, 40, 3) * 255).astype(np.uint8)).save(
                root / f"train{side}" / f"{i}.jpg")
    yield Summer2WinterDataset(
        str(root), "train", augment=AugmentConfig(out_size=32, hflip_p=0.5),
        color_jitter=ColorJitterConfig(0.2, 0.2, 0.2, 0.1), uint8_output=True)
    port_loader.close_pool()


@pytest.mark.parametrize("processes,share", [(None, 100.0), (False, 0.0)])
def test_share_reads_where_the_batches_were_built(dataset, processes, share):
    task = create_task("autoencoder", model=ModelConfig(32, 8, 8),
                       paired=False, device="cpu")
    task.init(0)
    loader = DataLoader(dataset, 2, shuffle=True, num_workers=2,
                        use_processes=processes)
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            Engine(task).train_epoch(loader, progress=False)
        assert READ(_ctx(STEPS)) == share
    finally:
        spans.reset()


def test_share_without_counts_reads_nothing(monkeypatch):
    """Units without ``counts`` (the program before the counter) or with
    none of the loader's read None, as does a context without a span."""
    assert READ(SimpleNamespace(span=None)) is None
    for unit in ({}, {"counts": {}}):
        monkeypatch.setattr(spans, "units", lambda u=unit: [
            dict(u, name="vct.step")] * STEPS)
        assert READ(_ctx(STEPS)) is None
