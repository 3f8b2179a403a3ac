"""``python -m vae_cyclegan_tpu_torch.import_checkpoint`` against the source
task and against the JAX package's ``scripts/import_torch_checkpoint.py``.

* A reference-layout ``.pth`` (``model_state_dict``, ``optimizer_states``,
  ``epoch``, ``loss``, ``args``) made from seeded port weights after one
  step is imported; the port's ``test`` discovers the run, and
  ``test.load_model_for_inference`` gives a task whose ``generate`` is the
  source task's bit for bit, with its Adam states.
* JAX's import script, run on the same ``.pth``, builds a state whose
  ``generate`` matches the imported task's within tests/torch_families.py's
  image tolerances, on the same noise.
* ``--fresh_optimizer`` leaves the Adam moments at zero on both sides (the
  port's optimizers hold no state until their first step).
* The card is the default device.

Small size: image 32, base 8, latent 8, batch 2. JAX's script builds its
ModelConfig with the reference's base width, 64; the test hands it base 8
through a partial of the JAX ModelConfig, and takes the state it would
save instead of writing it with Orbax.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vae_cyclegan_tpu.config as jax_config
import vae_cyclegan_tpu.utils as jax_utils
from torch_families import _check_image
from vae_cyclegan_tpu.parallel.dp import eps_queue
from vae_cyclegan_tpu_torch import import_checkpoint
from vae_cyclegan_tpu_torch import test as port_test
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.models.tasks import create_task

REPO = Path(__file__).resolve().parents[1]
IMAGE, BASE, LATENT, BATCH = 32, 8, 8, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _source(name):
    """A seeded task after one train_step, and its reference-layout dict."""
    task = create_task(name, model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    task.init(4)
    rng = np.random.RandomState(0)
    task.train_step({k: rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
                     for k in ("x", "y")})
    pth = {"epoch": 3, "loss": 0.25,
           "model_state_dict": task.state_dict(),
           "optimizer_states": {k: opt.state_dict()
                                for k, opt in task.optimizers().items()},
           "args": {"paired": True, "dataset": "hypersim",
                    "source_modality": "depth", "target_modality": "normal"}}
    return task, pth


def _argv(name, pth, out, *extra):
    return ["--pth", str(pth), "--architecture", name, "--out", str(out),
            "--image_size", str(IMAGE), "--latent_dim", str(LATENT), *extra]


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    eps = rng.randn(BATCH, IMAGE // 16, IMAGE // 16, LATENT).astype(
        np.float32)
    return x, eps


def _jax_import(monkeypatch, name, pth, out, *extra):
    """The state JAX's import script would save for `pth`, and its task."""
    spec = importlib.util.spec_from_file_location(
        "jax_import_script", REPO / "scripts" / "import_torch_checkpoint.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(jax_config, "ModelConfig", functools.partial(
        jax_config.ModelConfig, base_width=BASE))
    saved = []
    monkeypatch.setattr(jax_utils, "save_checkpoint",
                        lambda state, *a, **k: saved.append(state))
    assert script.main(_argv(name, pth, out, *extra)) == 0
    monkeypatch.undo()
    from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
    jtask = jax_create_task(name, model=jax_config.ModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE), paired=True)
    return jtask, saved[0]


def _moments(task):
    names = {id(p): n for n, p in task.nets.named_parameters()}
    return {key: {names[id(p)]: (s["exp_avg"], s["exp_avg_sq"], s["step"])
                  for p, s in opt.state.items()}
            for key, opt in task.optimizers().items()}


@pytest.mark.parametrize("name", ["vae", "cyclevaegan"])
def test_import_then_test_discovers_the_run(name, tmp_path, monkeypatch):
    source, pth = _source(name)
    torch.save(pth, tmp_path / "best_model.pth")
    out = tmp_path / "runs" / "imported"
    assert import_checkpoint.main(
        _argv(name, tmp_path / "best_model.pth", out, "--base_width",
              str(BASE), "--paired", "--platform", "cpu")) == 0
    (run,) = port_test.discover_runs(str(out.parent))
    assert run["args"]["architecture"] == name
    assert json.loads((out / "args.json").read_text())["base_width"] == BASE
    task = port_test.load_model_for_inference(run, device="cpu")
    got_sd, want_sd = task.state_dict(), source.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    got_m, want_m = _moments(task), _moments(source)
    assert got_m.keys() == want_m.keys()
    for key in want_m:
        assert got_m[key].keys() == want_m[key].keys()
        for n, tensors in want_m[key].items():
            for a, b in zip(got_m[key][n], tensors):
                assert torch.equal(a, b), (key, n)
    meta = json.loads((out / "best_model" / "meta.json").read_text())
    assert (meta["epoch"], meta["loss"]) == (3, 0.25)
    x, eps = _inputs()
    port = task.generate({"x": x}, eps=eps)
    assert torch.equal(port, source.generate({"x": x}, eps=eps))

    # JAX's script on the same file: its state's generate, same noise
    jtask, state = _jax_import(monkeypatch, name,
                               tmp_path / "best_model.pth",
                               tmp_path / "jax_run", "--paired")

    def gen(st, b, e):
        with eps_queue([e]):
            return jtask.generate(st, b, jax.random.PRNGKey(1))

    want = np.asarray(jax.jit(gen)(state, {"x": jnp.asarray(x)},
                                   jnp.asarray(eps)))
    _check_image(port.numpy(), want)


def test_fresh_optimizer_leaves_the_moments_at_zero(tmp_path, monkeypatch):
    name = "vae"
    _, pth = _source(name)
    torch.save(pth, tmp_path / "m.pth")
    out = tmp_path / "runs" / "fresh"
    assert import_checkpoint.main(
        _argv(name, tmp_path / "m.pth", out, "--base_width", str(BASE),
              "--fresh_optimizer", "--platform", "cpu")) == 0
    state = torch.load(out / "best_model" / "state.pth", weights_only=True)
    assert state["optimizer_states"]["optimizer"]["state"] == {}
    (run,) = port_test.discover_runs(str(out.parent))
    task = port_test.load_model_for_inference(run, device="cpu")
    assert all(not opt.state for opt in task.optimizers().values())
    # the moments are imported without the flag
    again = tmp_path / "runs" / "moments"
    assert import_checkpoint.main(
        _argv(name, tmp_path / "m.pth", again, "--base_width", str(BASE),
              "--platform", "cpu")) == 0
    state = torch.load(again / "best_model" / "state.pth", weights_only=True)
    assert state["optimizer_states"]["optimizer"]["state"]
    # JAX's script with the flag: zero moments, count 0
    _, jstate = _jax_import(monkeypatch, name, tmp_path / "m.pth",
                            tmp_path / "jax_run", "--fresh_optimizer")
    leaves = jax.tree_util.tree_leaves(
        {k: (v[0].mu, v[0].nu) for k, v in jstate.opt_state.items()})
    assert leaves and all(not np.asarray(a).any() for a in leaves)
    assert {int(v[0].count) for v in jstate.opt_state.values()} == {0}


def test_import_checkpoint_wants_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pth = _source("vae")
    torch.save(pth, tmp_path / "m.pth")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import_checkpoint.main(_argv("vae", tmp_path / "m.pth",
                                     tmp_path / "out", "--base_width",
                                     str(BASE)))
