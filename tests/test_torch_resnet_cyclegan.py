"""The port's CycleGAN (``create_task("cyclegan")``: ResNet-9 generators,
70x70 PatchGANs, 50-image history pools) against the plain float32
reference of the benchmark (``portbench/reference/families/cyclegan.py``,
networks in ``portbench/reference/resnet_nets.py``), on the CPU at a small
size with seeded weights. The JAX package has no CycleGAN, so that
reference is the only yardstick here: a second implementation of the
published equations that imports nothing of the port.

* One training step in f32: G_loss, D_loss and every term and score, each
  first gradient leaf, the update; then two more steps with the pools
  filling; the generated images.
* The pools' selections, index for index against the reference's per-image
  loop on one stream, over steps that reach the full-pool branch, with two
  images of one batch swapping into the same slot.
* The published parameter counts and ``state_dict`` keys at 256x256.
* The refusals of data and spatial parallelism, one ``train.py
  --architecture cyclegan`` epoch, ``run_inference``.
"""

import json
import math
import re

import numpy as np
import pytest
import torch
from PIL import Image

from portbench import check, harness, weights
from portbench.drivers.train import build_task
from portbench.reference.families import cyclegan as ref_cyclegan
from portbench.reference.steps import family
from vae_cyclegan_tpu_torch import train as port_train
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.inference import run_inference
from vae_cyclegan_tpu_torch.models import image_pool
from vae_cyclegan_tpu_torch.models.tasks import ARCHITECTURES, create_task
from vae_cyclegan_tpu_torch.models.tasks.resnet_cyclegan import (
    NO_DATA,
    NO_SPATIAL,
)
from vae_cyclegan_tpu_torch.parallel import spatial
from vae_cyclegan_tpu_torch.utils import checkpoint_exists

IMAGE, BASE, BATCH = 64, 8, 3
CONFIG = harness.HERE / "configs" / "cyclegan-resnet9-256.json"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    cfg = json.loads(CONFIG.read_text())
    cfg.update(image_size=IMAGE, base_width=BASE, compute_dtype="float32",
               **kw)
    return cfg


def _pair(seed=5):
    cfg = _cfg()
    task = build_task(cfg, seed, "cpu")
    fam = family(cfg)
    fam.load(weights.make(cfg, harness.sub_seed(seed, 0), "cpu"))
    return task, fam


def _batches(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand(BATCH, IMAGE, IMAGE, 3, generator=g),
             torch.rand(BATCH, IMAGE, IMAGE, 3, generator=g))
            for _ in range(n)]


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _first_grads(task):
    """The first gradient as Adam got it, m_1 / (1 - beta1), by leaf."""
    out = {}
    for name, p in task.nets.named_parameters():
        for opt in task.optimizers().values():
            state = opt.state.get(p)
            if state:
                out[name] = state["exp_avg"] / 0.5
    return out


def test_first_step_matches_the_reference():
    """Step 1 in f32: every metric the reference reports within 1e-5
    relative (one rounding order against another over sums of 10^5
    values; measured 8e-7), each first gradient leaf within 1e-3 of the
    larger of its norm and the median leaf's (rounding amplified by the
    InstanceNorm backward over 8x8 and 16x16 planes; measured under 1e-5
    on most leaves), and the update. Adam's first step is lr times the
    gradient's sign, so an element whose gradient is rounding on either
    side moves 2 lr apart: at most 1% of a leaf's elements may (measured 1
    of 9,216 in one leaf), the leaves whose whole gradient is rounding left
    out (``check.moving_leaves``: conv biases InstanceNorm cancels)."""
    task, fam = _pair()
    (x, y), = _batches(1)
    m = task.train_step({"x": x, "y": y},
                        generator=torch.Generator().manual_seed(3))
    mine, gg, dg = fam.step(_nchw(x), _nchw(y),
                            torch.Generator().manual_seed(3))
    assert {"G_loss", "D_loss", "loss_cycle", "loss_identity",
            "D_loss_x_real", "D_loss_y_fake", "d_x_real_mean"} <= set(mine)
    assert set(mine) <= set(m)
    for k, v in mine.items():
        assert abs(float(m[k]) - v) <= 1e-5 * abs(v), k
    names = {id(p): n for n, p in fam.nets.named_parameters()}
    ref = {names[id(p)]: g for p, g in zip(fam.gen_params + fam.disc_params,
                                           gg + dg)}
    prog = _first_grads(task)
    assert prog.keys() == ref.keys()
    median = float(np.median([float(g.norm()) for g in ref.values()]))
    for k, g in ref.items():
        gap = float((prog[k] - g).norm()) / max(float(g.norm()), median)
        assert gap < 1e-3, (k, gap)
    params = dict(fam.nets.named_parameters())
    mine = dict(task.nets.named_parameters())
    moving = check.moving_leaves({k: float(g.norm()) for k, g in ref.items()})
    assert len(moving) > len(ref) / 2
    lr = json.loads(CONFIG.read_text())["adam"]["lr"]
    for k in moving:
        apart = (mine[k] - params[k]).abs() > lr / 2
        assert float(apart.float().mean()) <= 0.01, k


def test_three_steps_and_the_images_match_the_reference():
    """G_A's images from fresh weights within 1e-4 of the reference's (f32
    rounding through 15 convs; measured 5e-6), then three steps with the
    pools filling (9 of 50 images): G_loss and D_loss of each within 1e-3
    relative (the elements whose first Adam step flipped with a rounding
    gradient move the later losses; measured at most 1.7e-4 over three
    seeds)."""
    task, fam = _pair(7)
    x = _batches(1, seed=4)[0][0]
    got = task.generate({"x": x})
    want = fam.generate(_nchw(x), None).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    gen_p = torch.Generator().manual_seed(11)
    gen_r = torch.Generator().manual_seed(11)
    for x, y in _batches(3, seed=2):
        m = task.train_step({"x": x, "y": y}, generator=gen_p)
        mine, _, _ = fam.step(_nchw(x), _nchw(y), gen_r)
        for k in ("G_loss", "D_loss"):
            assert abs(float(m[k]) - mine[k]) <= 1e-3 * abs(mine[k]), k
    assert task.pools["A"].count == len(fam.pools["A"].images) == 9


@pytest.mark.parametrize("size,batch,steps", [(4, 3, 6), (2, 4, 5)])
def test_pool_selections_match_the_reference(size, batch, steps):
    """The program's pool (host decisions, two device gathers) and the
    reference's per-image loop, each on a stream seeded alike, hand the
    discriminator the same images, index for index, and end with the same
    pool, over queries that fill the pool and then reach the swap branch;
    in some query an image swaps into a slot an earlier image of the same
    batch wrote, and reads that image back."""
    read_back = 0
    for seed in range(8):
        prog = image_pool.ImagePool("A", size, (1, 2, 2), torch.float32,
                                    "cpu")
        ref = ref_cyclegan.ImagePool(size)
        s_p = torch.Generator().manual_seed(seed)
        s_r = torch.Generator().manual_seed(seed)
        for step in range(steps):
            fresh = (100.0 * step + torch.arange(batch, dtype=torch.float32)
                     ).reshape(batch, 1, 1, 1).expand(batch, 1, 2, 2)
            ahead = torch.Generator()
            ahead.set_state(s_p.get_state())
            out, _, _, _ = image_pool.plan(prog.count, size, batch, ahead)
            read_back += sum(o >= size and o != size + i
                             for i, o in enumerate(out))
            got = prog.query(fresh.clone(), s_p)
            want = ref.query(fresh.clone(), s_r)
            assert torch.equal(got, want), (seed, step)
        assert torch.equal(prog.images, torch.cat(ref.images)), seed
        assert prog.count == len(ref.images) == size
    assert read_back > 0


def test_pool_passes_through_without_a_stream():
    pool = image_pool.ImagePool("B", 50, (3, 4, 4), torch.float32, "cpu")
    fresh = torch.rand(5, 3, 4, 4)
    assert pool.query(fresh, None) is fresh and pool.count == 0


def test_parameter_counts_and_published_keys():
    """11,378,179 parameters a generator and 2,764,737 a discriminator at
    ngf = ndf = 64, under the published state_dict keys and shapes."""
    task = create_task("cyclegan", model=ModelConfig(256, 64, 64),
                       device="meta")
    sd = task.state_dict()
    g_keys = [f"model.{i}.{p}" for i in (1, 4, 7) for p in ("weight", "bias")]
    g_keys += [f"model.{i}.conv_block.{j}.{p}" for i in range(10, 19)
               for j in (1, 5) for p in ("weight", "bias")]
    g_keys += [f"model.{i}.{p}" for i in (19, 22, 26)
               for p in ("weight", "bias")]
    d_keys = [f"model.{i}.{p}" for i in (0, 2, 5, 8, 11)
              for p in ("weight", "bias")]
    want = {f"{n}.{k}" for n in ("G_A", "G_B") for k in g_keys}
    want |= {f"{n}.{k}" for n in ("D_A", "D_B") for k in d_keys}
    assert set(sd) == want
    for net, n in (("G_A", 11_378_179), ("G_B", 11_378_179),
                   ("D_A", 2_764_737), ("D_B", 2_764_737)):
        assert sum(v.numel() for k, v in sd.items()
                   if k.startswith(net + ".")) == n
    assert sd["G_A.model.1.weight"].shape == (64, 3, 7, 7)
    assert sd["G_A.model.19.weight"].shape == (256, 128, 3, 3)  # transposed
    assert sd["G_A.model.22.weight"].shape == (128, 64, 3, 3)
    assert sd["D_A.model.11.weight"].shape == (1, 512, 4, 4)
    ref = family(json.loads(CONFIG.read_text()), device="meta")
    assert {k: v.shape for k, v in ref.nets.state_dict().items()} == {
        k: v.shape for k, v in sd.items()}
    x = torch.empty(2, 3, 256, 256, device="meta")
    assert task.nets["D_A"](x).shape == (2, 1, 30, 30)
    assert task.nets["G_A"](x).shape == (2, 3, 256, 256)


def _s2w_tree(root):
    rng = np.random.RandomState(0)
    for sub, n in (("trainA", 4), ("trainB", 3), ("testA", 2),
                   ("testB", 2)):
        d = root / "summer2winter" / sub
        d.mkdir(parents=True)
        for i in range(n):
            arr = (rng.rand(40, 48, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{i:03d}.jpg")
    return root


def _argv(root, out, *extra):
    return ["--platform", "cpu", "--architecture", "cyclegan", "--dataset",
            "summer2winter", "--data_dir", str(root), "--image_size", "32",
            "--base_width", "8", "--batch_size", "2", "--epochs", "1",
            "--output_dir", str(out), "--save_freq", "1",
            "--log_image_freq", "1", "--quiet", "--num_workers", "1", *extra]


@pytest.mark.parametrize("flags,match", [
    (["--num_devices", "2"], NO_DATA), (["--spatial", "2"], NO_SPATIAL),
    (["--multihost"], NO_DATA)], ids=["num-devices-2", "spatial-2",
                                      "multihost"])
def test_train_refuses_parallelism(flags, match, tmp_path):
    args = port_train.build_parser().parse_args(
        _argv(tmp_path, tmp_path / "runs", *flags))
    with pytest.raises(NotImplementedError, match=match.split(":")[0]):
        port_train.main(args)
    assert not (tmp_path / "runs").exists()


@pytest.mark.parametrize("name", sorted(ARCHITECTURES))
def test_refuse_parallel_names_only_cyclegans_missing_pieces(name):
    """``Task.refuse_parallel``, which ``train.py`` asks before any rank
    starts: the one-device ``cyclegan`` refuses data ranks and split rows,
    every other task any layout."""
    cls = ARCHITECTURES[name]
    cls.refuse_parallel(1, False)
    if name != "cyclegan":
        cls.refuse_parallel(4, True)
        return
    with pytest.raises(NotImplementedError, match=re.escape(NO_DATA)):
        cls.refuse_parallel(2, False)
    with pytest.raises(NotImplementedError, match=re.escape(NO_SPATIAL)):
        cls.refuse_parallel(1, True)


def test_task_refuses_a_spatial_scope():
    task = create_task("cyclegan", model=ModelConfig(32, 8, 8), device="cpu")
    batch = {k: torch.rand(2, 32, 32, 3) for k in "xy"}
    with spatial.spatial_scope(spatial.single()):
        with pytest.raises(NotImplementedError, match="spatial"):
            task.train_step(batch)


def test_train_runs_an_epoch(tmp_path):
    """``train.py --architecture cyclegan --dataset summer2winter``: one
    epoch of two batches, validation, a checkpoint with finite loss."""
    root = _s2w_tree(tmp_path / "data")
    run_dir = port_train.main(port_train.build_parser().parse_args(
        _argv(root, tmp_path / "runs")))
    assert run_dir.name.startswith("cyclegan_")
    ckpt = run_dir / "checkpoint_epoch_1"
    assert checkpoint_exists(ckpt)
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["epoch"] == 0 and math.isfinite(meta["loss"])
    state = torch.load(ckpt / "state.pth", weights_only=True)
    assert set(state["optimizer_states"]) == {"optimizer_G", "optimizer_D"}


def test_run_inference_is_the_generator_in_unit_range():
    """run_inference clips (G_A(2x - 1) + 1) / 2 to [0, 1]: within 1e-5 of
    the reference's image (f32 rounding), noise seed irrelevant."""
    task, fam = _pair(9)
    x = torch.rand(2, IMAGE, IMAGE, 3)
    got = run_inference(task, {"x": x.numpy()}, seed=3)
    assert got.dtype == np.float32 and got.shape == (2, IMAGE, IMAGE, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0
    want = fam.generate(_nchw(x), None).clamp(0, 1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(run_inference(task, {"x": x}, seed=4), got)
