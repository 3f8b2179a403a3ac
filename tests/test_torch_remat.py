"""Rematerialization in the port (``ModelConfig.remat``,
``Task._maybe_remat``; ROADMAP.md queue 1, item 9).

* A remat step equals a step without remat bit for bit on the CPU (torch on
  one thread), two steps of vae, doublevae and cyclevaegan: with the noise
  given, and with the noise drawn from one seeded ``torch.Generator``. The
  second is the trap: ``torch.utils.checkpoint`` replays only the default
  generators, so a pass that drew its noise inside the checkpointed call
  from an explicit generator would recompute with other noise (a wrong
  gradient) and leave the generator further on.
* The remat step recomputes: the kernel sites of its generator forwards
  are recorded again in its backward (``kernels.record_sites``).
* Against JAX's ``ModelConfig(remat=True)`` step from the same state, within
  the one-step tolerances of tests/torch_families.py.
* ``python -m vae_cyclegan_tpu_torch.train --remat --platform cpu`` runs an
  epoch; the bench takes ``BENCH_REMAT=1`` at a tiny size on the CPU.

Small size: image 32, base 8, latent 8, batch 2.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_bench import TINY, run_bench
from torch_families import check_train_step, run_pair
from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch import train as port_train
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.models.tasks import ARCHITECTURES, create_task

IMAGE, BASE, LATENT, BATCH = 32, 8, 8, 2
NAMES = ("vae", "doublevae", "cyclevaegan")
# bounds on the share of parameter elements the first Adam step moved the
# other way than JAX's: vae's of tests/test_torch_families_simple.py;
# cyclevaegan measured 0.0473 with remat, the same as without, held to
# about twice that as tests/test_torch_unpaired.py holds its 0.0478
FLIPPED = {"vae": 0.01, "cyclevaegan": 0.10}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _steps(name, remat, drawn, steps=2):
    """The metrics of `steps` train_steps from task.init(0), the final
    state_dict and the noise generator's state; the noise given (`drawn`
    False) or drawn from one generator seeded 5."""
    task = create_task(name, model=ModelConfig(IMAGE, LATENT, BASE,
                                               remat=remat), device="cpu")
    task.init(0)
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(5)
    metrics = []
    for _ in range(steps):
        batch = {k: rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
                 for k in ("x", "y")}
        eps = None if drawn else [
            rng.randn(BATCH, IMAGE // 16, IMAGE // 16, LATENT)
            .astype(np.float32) for _ in task.train_passes]
        metrics.append(task.train_step(batch, eps=eps, generator=gen))
    state = {k: v.clone() for k, v in task.state_dict().items()}
    return metrics, state, gen.get_state()


@pytest.mark.parametrize("drawn", [False, True], ids=["eps", "generator"])
@pytest.mark.parametrize("name", NAMES)
def test_remat_step_equals_plain_step(name, drawn):
    plain, plain_sd, plain_gen = _steps(name, False, drawn)
    remat, remat_sd, remat_gen = _steps(name, True, drawn)
    for a, b in zip(plain, remat):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), key
    assert plain_sd.keys() == remat_sd.keys()
    for key in plain_sd:
        assert torch.equal(plain_sd[key], remat_sd[key]), key
    # the generator drew each pass's noise once
    assert torch.equal(plain_gen, remat_gen)


@pytest.mark.parametrize("name", NAMES)
def test_remat_recomputes_the_generator_forwards(name):
    """The remat step records each generator forward's kernel sites a
    second time (the recompute in the backward), the discriminators' and
    the backward's once; generate's sites are the same either way."""
    counts = {}
    for remat in (False, True):
        task = create_task(name, model=ModelConfig(IMAGE, LATENT, BASE,
                                                   remat=remat), device="cpu")
        task.init(0)
        batch = {k: torch.rand(BATCH, IMAGE, IMAGE, 3) for k in ("x", "y")}
        with kernels.record_sites() as train:
            task.train_step(batch)
        with kernels.record_sites() as forward:
            task.generate(batch)
        counts[remat] = (Counter(s[0] for s in train),
                         Counter(s[0] for s in forward))
    (plain, one_pass), (remat, remat_pass) = counts[False], counts[True]
    assert one_pass == remat_pass and one_pass["in_act"] > 0
    passes = len(ARCHITECTURES[name].train_passes)
    assert remat == plain + Counter(
        {k: passes * n for k, n in one_pass.items()})


@pytest.mark.parametrize("name", ["vae", "cyclevaegan"])
def test_remat_step_matches_jax_remat(name):
    """One remat train_step against JAX's remat=True step from the same
    state, with the same noise: tests/torch_families.py's one-step
    tolerances (metrics rtol 1e-3, spectral u/v 1e-6, parameters within
    2 lr, the flipped share)."""
    check_train_step(run_pair(name, remat=True), name, FLIPPED[name])


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """8 paired depth/normal samples of 40x56 frames."""
    root = tmp_path_factory.mktemp("remat_data")
    rng = np.random.RandomState(0)
    for scene in ("ai_001_001_indoor", "ai_001_002_outdoor"):
        d = root / "hypersim" / scene / "cam_00"
        d.mkdir(parents=True)
        for frame in range(4):
            for mod in ("depth", "normal"):
                arr = (rng.rand(40, 56, 3) * 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"frame_{frame:04d}_{mod}.png")
    return root


def test_train_remat_runs_an_epoch(data_root, tmp_path, monkeypatch):
    """--remat is accepted: the driver builds a remat task and trains an
    epoch of finite, unskipped steps."""
    built = []
    build = port_train.build_task

    def recording(args, device):
        task = build(args, device)
        built.append(task)
        return task

    monkeypatch.setattr(port_train, "build_task", recording)
    args = port_train.build_parser().parse_args([
        "--platform", "cpu", "--architecture", "cyclevaegan", "--paired",
        "--data_dir", str(data_root), "--source_modality", "depth",
        "--target_modality", "normal", "--image_size", str(IMAGE),
        "--base_width", str(BASE), "--latent_dim", str(LATENT),
        "--batch_size", str(BATCH), "--epochs", "1", "--test_split", "0.25",
        "--output_dir", str(tmp_path), "--save_freq", "1", "--quiet",
        "--remat"])
    port_train.main(args)
    (task,) = built
    assert task.mc.remat
    (run,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert (run / "best_model" / "state.pth").exists()
    state = torch.load(run / "best_model" / "state.pth", weights_only=True)
    assert np.isfinite(state["loss"])
    steps = {int(s["step"]) for opt in state["optimizer_states"].values()
             for s in opt["state"].values()}
    assert steps == {3}  # 6 training samples at batch 2, none skipped


def test_bench_takes_bench_remat():
    """BENCH_REMAT=1 runs the bench's step with remat (the line says so);
    the other unported switches stay refused (test_torch_bench.py)."""
    env = {**TINY, "BENCH_ARCH": "vae", "BENCH_REMAT": "1",
           "BENCH_E2E": "0", "BENCH_LOADER_ONLY": "0", "BENCH_TRACE": "0"}
    rc, lines, err = run_bench(env)
    assert rc == 0, err
    (line,) = lines
    assert line["remat"] is True and line["value"] > 0
    rc, lines, err = run_bench({**env, "BENCH_REMAT": "0"})
    assert rc == 0 and lines[0]["remat"] is False, err
