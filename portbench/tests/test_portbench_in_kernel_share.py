"""``in_kernel_share.train`` on a session recorded on the CPU at a tiny
size (an autoencoder through ``Engine.train_epoch``): the per cent of the
step's IN+act sites the program sent to a kernel by the CPU's rule (JAX's
slab rule: all of them at 32 px, some at 128 px, where the head and U4
slabs are 2 MB), and None where the units hold no count of the sites (a
program without the counter)."""

from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from portbench.metrics import reader
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.data import DataLoader
from vae_cyclegan_tpu_torch.engine import Engine
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.ops import instance_norm as tin
from vae_cyclegan_tpu_torch.utils import spans

STEPS = 3
READ = reader("in_kernel_share.train")


def _ctx(units):
    return SimpleNamespace(span=SimpleNamespace(units=units))


class _Frames:
    """STEPS one-image batches of seeded float frames of `image` px."""

    def __init__(self, image):
        self.image = image

    def __len__(self):
        return STEPS

    def get(self, idx, rng):
        r = np.random.RandomState(idx)
        return {k: r.rand(self.image, self.image, 3).astype(np.float32)
                for k in ("x", "y")}


@pytest.mark.parametrize("image,base", [(32, 8), (128, 32)])
def test_share_reads_the_sites_on_a_kernel(monkeypatch, image, base):
    """The share over the span's units is the share of the rule's calls
    that named a kernel (counts land in the unit after their step's, so the
    span's first unit holds none and its last step's go to no unit)."""
    task = create_task("autoencoder", model=ModelConfig(image, 8, base),
                       device="cpu")
    task.init(0)
    picks = []
    rule = tin.site_kernel

    def recorded(shape, device, mode):
        picks.append(rule(shape, device, mode))
        return picks[-1]

    monkeypatch.setattr(tin, "site_kernel", recorded)
    loader = DataLoader(_Frames(image), 1, num_workers=1,
                        use_processes=False)
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            Engine(task).train_epoch(loader, progress=False)
        share = READ(_ctx(STEPS))
    finally:
        spans.reset()
    want = 100.0 * sum(p is not None for p in picks) / len(picks)
    assert share == pytest.approx(want)
    assert share == 100.0 if image == 32 else 0.0 < share < 100.0


def test_share_without_counts_reads_nothing(monkeypatch):
    """Units without ``counts`` (the program before the counter) or with
    none of the sites' read None, as does a context without a span."""
    assert READ(SimpleNamespace(span=None)) is None
    for unit in ({}, {"counts": {}}, {"counts": {"image_pool.fresh": 4}}):
        monkeypatch.setattr(spans, "units", lambda u=unit: [
            dict(u, name="vct.step")] * STEPS)
        assert READ(_ctx(STEPS)) is None
