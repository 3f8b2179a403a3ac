"""The port's checkpoints and Double*->Cycle* transfer against the JAX
package (vae_cyclegan_tpu_torch/utils/checkpoint.py, utils/transfer.py).

* Round trip: save after one step, load into a fresh task and engine; the
  weights, the spectral u/v, both Adam states and the training generator
  come back bit for bit, for the ten families.
* The JAX package's reader: ``torch_import.load_into_state`` and
  ``load_adam_moments_into_state`` take the port's ``state.pth`` into a JAX
  TrainState; its params (bridged back with ``params_from_jax``) and its
  Adam mu / nu / count equal the port's tensors bit for bit.
* Resume: two epochs straight against one epoch and ``--resume`` for one,
  through the driver, give the same final state bit for bit (f32, CPU, torch
  on one thread: a step's sums are split over the intra-op threads).
* Transfer: bit for bit against JAX's ``load_pretrained_double{ae,vae}_
  to_cycle`` from the same bridged weights; G and F share no storage; a
  missing subtree raises KeyError on both sides, a swapped table the
  reference's AssertionError.

Small size: image 32, base 8, latent 8, batch 2, one step.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu.utils import torch_import
from vae_cyclegan_tpu.utils import transfer as jax_transfer
from vae_cyclegan_tpu_torch import train
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.engine import Engine
from vae_cyclegan_tpu_torch.models.tasks import ARCHITECTURES, create_task
from vae_cyclegan_tpu_torch.utils import (
    checkpoint_exists,
    load_checkpoint,
    load_pretrained_doubleae_to_cycle,
    load_pretrained_doublevae_to_cycle,
    save_checkpoint,
    transfer,
)
from vae_cyclegan_tpu_torch.utils.jax_import import params_from_jax

IMAGE, BASE, LATENT, BATCH = 32, 8, 8, 2
MC = ModelConfig(IMAGE, LATENT, BASE)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
            for k in ("x", "y")}


def _stepped(name, seed=0):
    """A task after one train_step, and its engine whose generator has
    drawn that step's noise."""
    task = create_task(name, model=MC, device="cpu")
    task.init(seed)
    engine = Engine(task, seed=seed + 5)
    m = task.train_step(_batch(seed), generator=engine.generator)
    assert float(m["nan_detected"]) == 0.0
    return task, engine


def _np_sd(task):
    return {k: v.numpy().copy() for k, v in task.state_dict().items()}


def _moments(task):
    """{optimizer key: {param name: (exp_avg, exp_avg_sq, step)}}."""
    names = {id(p): n for n, p in task.nets.named_parameters()}
    return {key: {names[id(p)]: tuple(opt.state[p][k].clone()
                                      for k in ("exp_avg", "exp_avg_sq",
                                                "step"))
                  for group in opt.param_groups for p in group["params"]}
            for key, opt in task.optimizers().items()}


@pytest.mark.parametrize("name", sorted(ARCHITECTURES))
def test_checkpoint_round_trip(name, tmp_path):
    task, engine = _stepped(name)
    path = tmp_path / "checkpoint_epoch_1"
    save_checkpoint(task, 0, 1.25, {"architecture": name}, path, engine)
    assert checkpoint_exists(path)
    fresh = create_task(name, model=MC, device="cpu")
    fresh.init(7)
    fresh_engine = Engine(fresh, seed=11)
    assert fresh.optimizers().keys() == task.optimizers().keys()
    epoch, loss, args = load_checkpoint(fresh, path, fresh_engine)
    assert (epoch, loss, args) == (0, 1.25, {"architecture": name})
    got, want = fresh.state_dict(), task.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    mg, mw = _moments(fresh), _moments(task)
    assert mg.keys() == mw.keys()
    for key in mw:
        assert mg[key].keys() == mw[key].keys()
        for n in mw[key]:
            for a, b in zip(mg[key][n], mw[key][n]):
                assert torch.equal(a, b), (key, n)
    assert torch.equal(fresh_engine.generator.get_state(),
                       engine.generator.get_state())
    # the reference's .pth dict
    state = torch.load(path / "state.pth", weights_only=True)
    assert set(state) == {"epoch", "model_state_dict", "optimizer_states",
                          "loss", "args", "generator_state"}
    assert json.loads((path / "meta.json").read_text()) == {
        "epoch": 0, "loss": 1.25, "args": {"architecture": name}}


def test_load_checkpoint_missing_path(tmp_path):
    task = create_task("autoencoder", model=MC, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(task, tmp_path / "nope")


def _torch_layout_tree(arch, mu):
    """An imported moment tree in the layout params_from_jax takes."""
    if arch in ("cycleaegan", "cyclevaegan"):
        return {**mu["G"], **mu["D"]}
    if arch in ("aegan", "vaegan"):
        return {"G": mu["G"], "D": mu["D"]}
    return mu["model"]


@pytest.mark.parametrize("name", ["cyclevaegan", "aegan", "autoencoder",
                                  "doublevae"])
def test_jax_reads_port_checkpoint(name, tmp_path):
    """JAX's importer takes the port's state.pth into a JAX TrainState: the
    params and the Adam moments and counts are the port's, bit for bit."""
    task, engine = _stepped(name)
    save_checkpoint(task, 0, 0.5, {}, tmp_path / "ck", engine)
    state = torch.load(tmp_path / "ck" / "state.pth", weights_only=True)
    sd = {k: v.numpy() for k, v in state["model_state_dict"].items()}

    jtask = jax_create_task(name, model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE,
        use_pallas=False))
    template = jtask.init_state(jax.random.PRNGKey(0))
    jstate = torch_import.load_into_state(template, name, sd)
    jstate = torch_import.load_adam_moments_into_state(
        jstate, name, sd, state["optimizer_states"])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    spectral = np_tree(jstate.spectral) or None
    back = params_from_jax(np_tree(jstate.params), spectral)
    want = task.state_dict()
    assert back.keys() == want.keys()
    for k in want:
        assert torch.equal(back[k], want[k]), k

    moments = _moments(task)
    port = {n: v for group in moments.values() for n, v in group.items()}
    mu = {k: np_tree(v[0].mu) for k, v in jstate.opt_state.items()}
    nu = {k: np_tree(v[0].nu) for k, v in jstate.opt_state.items()}
    for i, tree in ((0, mu), (1, nu)):
        got = params_from_jax(_torch_layout_tree(name, tree), spectral)
        got = {k: v for k, v in got.items()
               if not k.endswith(("weight_u", "weight_v"))}
        assert got.keys() == port.keys()
        for k in port:
            assert torch.equal(got[k], port[k][i]), k
    counts = {int(v[0].count) for v in jstate.opt_state.values()}
    assert counts == {int(v[2]) for v in port.values()} == {1}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """8 paired depth samples of 40x56 frames: 6 train, 2 test."""
    root = tmp_path_factory.mktemp("ckpt_data")
    rng = np.random.RandomState(0)
    for scene in ("ai_001_001_indoor", "ai_001_002_outdoor"):
        d = root / "hypersim" / scene / "cam_00"
        d.mkdir(parents=True)
        for frame in range(4):
            arr = (rng.rand(40, 56, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"frame_{frame:04d}_depth.png")
    return root


def _argv(data, out, epochs, *extra):
    return ["--platform", "cpu", "--architecture", "vae", "--paired",
            "--data_dir", str(data), "--source_modality", "depth",
            "--target_modality", "depth", "--image_size", str(IMAGE),
            "--base_width", str(BASE), "--latent_dim", str(LATENT),
            "--batch_size", str(BATCH), "--epochs", str(epochs),
            "--test_split", "0.25", "--output_dir", str(out),
            "--save_freq", "1", "--log_image_freq", "1", "--quiet",
            "--num_workers", "2", *extra]


def test_resume_continues_the_run(tree, tmp_path):
    """VAE (its steps draw noise from the engine's generator): two epochs
    straight and one epoch + --resume for one end in the same weights, Adam
    states and generator, bit for bit."""
    parse = train.build_parser().parse_args
    straight = train.main(parse(_argv(tree, tmp_path / "a", 2)))
    split = train.main(parse(_argv(tree, tmp_path / "b", 1)))
    assert not (split / "checkpoint_epoch_2").exists()
    again = train.main(parse(_argv(
        tree, tmp_path / "b", 2, "--resume",
        str(split / "checkpoint_epoch_1"))))
    assert again == split
    a = torch.load(straight / "checkpoint_epoch_2" / "state.pth",
                   weights_only=True)
    b = torch.load(split / "checkpoint_epoch_2" / "state.pth",
                   weights_only=True)
    assert a["epoch"] == b["epoch"] == 1
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k
    oa, ob = a["optimizer_states"]["optimizer"], b["optimizer_states"]["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        assert int(st["step"]) == 6  # three steps an epoch
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert torch.equal(a["generator_state"], b["generator_state"])


TRANSFERS = [("doubleae", "cycleae"), ("doubleae", "cycleaegan"),
             ("doublevae", "cyclevae"), ("doublevae", "cyclevaegan")]


def _jax_state(name, seed):
    task = jax_create_task(name, model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE,
        use_pallas=False))
    return task.init_state(jax.random.PRNGKey(seed))


def _storages(module):
    return {p.untyped_storage().data_ptr() for p in module.parameters()}


@pytest.mark.parametrize("source,target", TRANSFERS)
def test_transfer_matches_jax(source, target):
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    double = _jax_state(source, 0)
    cycle = _jax_state(target, 1)
    jax_fn = (jax_transfer.load_pretrained_doubleae_to_cycle
              if source == "doubleae"
              else jax_transfer.load_pretrained_doublevae_to_cycle)
    port_fn = (load_pretrained_doubleae_to_cycle if source == "doubleae"
               else load_pretrained_doublevae_to_cycle)
    out = jax_fn(cycle, double.params["model"])
    spectral = np_tree(cycle.spectral) or None
    want = params_from_jax(np_tree(out.params), spectral)

    task = create_task(target, model=MC, device="cpu")
    task.load_state_dict(params_from_jax(np_tree(cycle.params), spectral))
    opt_before = {k: o.state_dict() for k, o in task.optimizers().items()}
    port_fn(task, params_from_jax(np_tree(double.params)))
    got = task.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not _storages(task.nets["G"]) & _storages(task.nets["F"])
    assert {k: o.state_dict() for k, o in task.optimizers().items()} == \
        opt_before


def test_transfer_missing_subtree_raises():
    """A DoubleAE state into a CycleVAE: KeyError on both sides."""
    double = _jax_state("doubleae", 0)
    with pytest.raises(KeyError):
        jax_transfer.load_pretrained_doublevae_to_cycle(
            _jax_state("cyclevae", 1), double.params["model"])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    task = create_task("cyclevae", model=MC, device="cpu")
    with pytest.raises(KeyError, match="vae_encoder_block_A"):
        load_pretrained_doublevae_to_cycle(
            task, params_from_jax(np_tree(double.params)))


def test_transfer_swapped_table_raises(monkeypatch):
    """The reference's sanity check fires if G were given the A decoder."""
    src = create_task("doubleae", model=MC, device="cpu")
    src.init(0)
    monkeypatch.setattr(transfer, "_DOUBLE_AE", (
        ("encoder", "encoder", "encoder"),
        ("decoder", "decoder_A", "decoder_B")))
    task = create_task("cycleae", model=MC, device="cpu")
    with pytest.raises(AssertionError, match="may be swapped"):
        load_pretrained_doubleae_to_cycle(task, src.state_dict())
