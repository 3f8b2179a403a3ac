"""The port's generator export (``vae_cyclegan_tpu_torch/utils/export.py``,
``python -m vae_cyclegan_tpu_torch.export``) against the task it came from
and against the JAX package's ``generate``.

* One program with a symbolic batch serves batch 1 and 3 after a disk round
  trip, bit for bit what the program did before it was saved, and within
  1e-6 of ``inference.run_inference(task, x, seed)`` (clipped as it clips):
  ``load``'s ``(x, seed)`` draws the noise as ``run_inference`` does.
* The seed moves vae's output and not autoencoder's; a fixed-batch program
  of cyclevaegan serves its batch and refuses another; a wrong rank is
  refused.
* With JAX's weights (``params_from_jax``) and the same noise, the program's
  output is JAX's ``generate`` within tests/torch_families.py's image
  tolerances.
* The graph holds one ``vct::`` node per kernel site: as many
  ``vct::in_act`` (``vct::in_act_tiled`` under "tiled") and
  ``vct::starved_conv`` nodes as ``kernels.record_sites`` reports for
  ``generate`` at the same shape (image 64, base 16, where U3's, U4's and
  the tail's convs take the starved conv).
* The CLI exports a run directory on the CPU and refuses a device the
  program cannot live on; without ``--platform`` it wants the card.

Small size: image 32, base 8, latent 8 (64 / 16 / 16 for the sites).
"""

import json
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_families import _check_image, np_tree
from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu.parallel.dp import eps_queue
from vae_cyclegan_tpu_torch import export as export_cli
from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.inference import run_inference
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.utils import export, save_checkpoint
from vae_cyclegan_tpu_torch.utils.jax_import import params_from_jax

IMAGE, BASE, LATENT = 32, 8, 8


def _task(name, size=(IMAGE, LATENT, BASE), instance_norm="auto", seed=0):
    task = create_task(name, model=ModelConfig(
        *size, instance_norm=instance_norm), device="cpu")
    task.init(seed)
    return task


def _images(batch, size=IMAGE, seed=0):
    return np.random.RandomState(seed).rand(batch, size, size, 3).astype(
        np.float32)


@pytest.mark.parametrize("name", ["vae", "autoencoder", "cyclevaegan"])
def test_symbolic_batch_round_trip(name, tmp_path):
    task = _task(name)
    program = export.export_generator(task)
    path = tmp_path / "g.pt2"
    export.save(program, path)
    served = export.load(path)
    assert served.meta["batch"] == "symbolic"
    assert served.meta["architecture"] == name
    assert served.device == torch.device("cpu")
    for batch, seed in ((1, 0), (3, 7)):
        x = _images(batch, seed=batch)
        got = served(x, seed)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (batch, IMAGE, IMAGE, 3)
        eps = served.noise(batch, seed)
        xt = torch.as_tensor(x)
        with torch.no_grad():
            assert torch.equal(got, program.module()(xt, eps))
        assert torch.equal(got, served.run(xt, eps))
        want = run_inference(task, {"x": x}, seed=seed)
        np.testing.assert_allclose(got.clamp(0, 1).numpy(), want, rtol=0,
                                   atol=1e-6)
    x = _images(2)
    moved = not torch.equal(served(x, 0), served(x, 1))
    assert moved == (name != "autoencoder")


def test_fixed_batch_and_wrong_shapes_are_refused(tmp_path):
    task = _task("cyclevaegan")
    program = export.export_generator(task, batch_size=2)
    export.save(program, tmp_path / "g.pt2")
    served = export.load(tmp_path / "g.pt2")
    assert served.meta["batch"] == 2
    x = _images(2)
    np.testing.assert_allclose(served(x, 3).clamp(0, 1).numpy(),
                               run_inference(task, {"x": x}, seed=3),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="NHWC"):
        served(_images(3), 0)
    with pytest.raises(ValueError, match="NHWC"):
        served(_images(2)[0], 0)  # rank 3
    with pytest.raises(ValueError, match="NHWC"):
        served(_images(2, size=64), 0)
    # the program itself guards its input shapes too
    with pytest.raises(Exception):
        served.run(torch.as_tensor(_images(2)[0]), served.noise(2, 0))


@pytest.mark.parametrize("name", ["vae", "cyclevaegan"])
def test_program_matches_jax_generate(name, tmp_path):
    """JAX's initial weights through params_from_jax, the same image and
    noise: the loaded program's output against JAX's generate."""
    jtask = jax_create_task(name, model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE))
    state = jax.jit(jtask.init_state)(jax.random.PRNGKey(0))
    task = create_task(name, model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    task.load_state_dict(params_from_jax(np_tree(state.params),
                                         np_tree(state.spectral)))
    export.save(export.export_generator(task), tmp_path / "g.pt2")
    served = export.load(tmp_path / "g.pt2")
    x = _images(2, seed=4)
    eps = np.random.RandomState(5).randn(
        2, IMAGE // 16, IMAGE // 16, LATENT).astype(np.float32)

    def gen(st, b, e):
        with eps_queue([e]):
            return jtask.generate(st, b, jax.random.PRNGKey(1))

    want = np.asarray(jax.jit(gen)(state, {"x": jnp.asarray(x)},
                                   jnp.asarray(eps)))
    got = served.run(torch.as_tensor(x), torch.as_tensor(eps)).numpy()
    _check_image(got, want)


def _vct_nodes(program):
    return Counter(str(n.target) for n in program.graph.nodes
                   if n.op == "call_function"
                   and str(n.target).startswith("vct."))


@pytest.mark.parametrize("instance_norm", ["auto", "tiled"])
def test_graph_holds_one_node_per_kernel_site(instance_norm):
    """Image 64, base 16: the slabs of at most 1 MB take K1 (every site
    takes K2 under "tiled" but U4's), U3, U4 and the tail take K3 (U3's
    conv is starved at this width too); the program's vct nodes are the
    sites generate records, kind by kind."""
    task = _task("cyclevaegan", (64, 16, 16), instance_norm)
    with kernels.record_sites() as sites:
        task.generate({"x": _images(2, 64)})
    want = Counter(f"vct.{kind}.default" for kind, *_ in sites)
    conv = "vct.starved_conv.default"
    norm = ("vct.in_act_tiled.default" if instance_norm == "tiled"
            else "vct.in_act.default")
    assert want[conv] == 3 and want[norm] > 0
    assert _vct_nodes(export.export_generator(task)) == want


def _run_dir(tmp_path, name="vae"):
    task = _task(name, seed=3)
    run = tmp_path / "run"
    args = {"architecture": name, "image_size": IMAGE, "latent_dim": LATENT,
            "base_width": BASE, "paired": True}
    run.mkdir()
    (run / "args.json").write_text(json.dumps(args))
    save_checkpoint(task, 1, 0.5, args, run / "best_model")
    return task, run


def test_export_cli_on_the_cpu(tmp_path, capsys):
    task, run = _run_dir(tmp_path)
    out = tmp_path / "g.pt2"
    assert export_cli.main(["--run_dir", str(run), "--out", str(out),
                            "--platform", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("exported vae generator (32x32, batch symbolic, "
                           "platforms ['cpu']) -> ")
    served = export.load(out)
    x = _images(3)
    np.testing.assert_allclose(served(x, 2).clamp(0, 1).numpy(),
                               run_inference(task, {"x": x}, seed=2),
                               rtol=0, atol=1e-6)
    assert export_cli.main(["--run_dir", str(run), "--out", str(out),
                            "--platform", "cpu", "--batch", "4"]) == 0
    assert export.load(out).meta["batch"] == 4
    with pytest.raises(SystemExit, match="platforms"):
        export_cli.main(["--run_dir", str(run), "--out", str(out),
                         "--platform", "cpu", "--platforms", "cpu,cuda"])
    with pytest.raises(SystemExit, match="args.json"):
        export_cli.main(["--run_dir", str(tmp_path), "--out", str(out),
                         "--platform", "cpu"])


def test_export_cli_wants_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, run = _run_dir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["--run_dir", str(run), "--out",
                         str(tmp_path / "g.pt2")])
