"""Data parallelism of the port (``vae_cyclegan_tpu_torch/parallel``) on the
CPU over gloo, against the port's one-process step over the global batch
and against the JAX package (the counterparts of tests/test_parallel.py,
which runs JAX on conftest's 8 virtual CPU devices).

Two ranks are spawned once for the file (``parallel.mesh.spawn``, start
method ``spawn``: this process has JAX loaded with its threads), and each
runs every case of ``torch_parallel_cases.run_cases`` on its shards; this
process runs the same cases over the global batches, and the JAX side.
Weights: the JAX task's initial state (``params_from_jax``), so one set of
weights serves all three. Small size: image 32, base 8, latent 8, f32, one
torch thread a process; global batch 4 (2 a rank).

Tolerances:

* ranks against the one-process step: every metric within 1e-5 relative
  (+1e-6; shard means against the whole batch's mean, measured at most
  1.2e-7 after one step); after the update, every parameter and buffer
  within 5e-4 (tests/test_parallel.py's bound: a gradient that is
  rounding noise becomes a full Adam step of either sign, 2 lr = 4e-4;
  measured 3.0e-4), Adam's moments (the gradient, and its square) within
  1e-3 relative L2 per tensor (tests/torch_families.py's bound on the
  discriminator's moments; measured 6.9e-6); the images of eval_step and
  generate bit for bit
  (each sample's pass is the same computation on its rank);
* ranks against JAX (autoencoder and aegan: JAX's shard_map engine on 2 of
  the 8 virtual devices; vae and cyclevaegan: JAX's one-device step with
  the global noise, each rank taking its rows): tests/torch_families.py's
  one-step bounds, every metric within 1e-3 relative (+1e-5), every
  parameter within one Adam quantum (2 lr + 1e-6), and at most the
  family's share of elements further apart than lr (metrics measured at
  most 9.0e-4, cyclevaegan's, as its one-process step reads);
* across the ranks: every parameter, buffer (spectral u, v) and Adam state
  bit for bit after each step, and after a second;
* the engine's epoch (11 samples in batches of 4: 4, 4 and a replicated 3)
  and validation against one process: the metric means within 1e-4
  relative after three updates (measured 1.5e-5, loss_kl), validation's
  within 1e-3 (measured 2.4e-4, loss_kl: the KL term reads exp(logvar) of
  the 2x2 bottleneck planes, which amplify an update's rounding).
"""

import importlib
import os
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.engine import Engine as JEngine
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu.parallel import make_mesh, replicate_state
from vae_cyclegan_tpu.parallel import shard_batch as jax_shard_batch
from vae_cyclegan_tpu.parallel.dp import eps_queue
from vae_cyclegan_tpu.utils import torch_import
from vae_cyclegan_tpu_torch import parallel
from vae_cyclegan_tpu_torch.parallel import mesh
from vae_cyclegan_tpu_torch.utils.jax_import import params_from_jax

IMAGE, BASE, LATENT, BATCH, WORLD = 32, 8, 8, 4, 2
LR = 2e-4
STEP_RTOL, STATE_ATOL, MOMENT_RTOL = 1e-5, 5e-4, 1e-3
JAX_RTOL = 1e-3
EPOCH_RTOL, VAL_RTOL = 1e-4, 1e-3
DRYRUN_RTOL = 5e-4
#: tests/test_torch_families_*.py's shares of elements further than lr
FLIPPED = {"autoencoder": 0.03, "vae": 0.01, "aegan": 0.02,
           "cyclevaegan": 0.04}
#: each step case: paired, and whether JAX runs it on its shard_map engine
#: (noise-free) or one device with the global noise
STEPS = {"autoencoder": (True, True), "vae": (True, False),
         "aegan": (True, True), "cyclevaegan": (False, False)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_task(name, paired):
    jtask = jax_create_task(name, model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE), paired=paired)
    state = jax.jit(jtask.init_state)(jax.random.PRNGKey(0))
    return jtask, state, params_from_jax(np_tree(state.params),
                                         np_tree(state.spectral))


def _with_eps(fn):
    def run(*args):
        *args, e = args
        with eps_queue(list(e)):
            return fn(*args)
    return jax.jit(run)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(the ranks' results, the one-process results, JAX's, the inputs'
    file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    inputs, want = {"steps": {}}, {}
    for name, (paired, sharded) in STEPS.items():
        jtask, state, params = _jax_task(name, paired)
        batch = {k: rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
                 for k in ("x", "y")}
        n_eps = len(cases.task_for(name, params, paired).train_passes)
        eps = [rng.randn(BATCH, IMAGE // 16, IMAGE // 16, LATENT).astype(
            np.float32) for _ in range(n_eps)]
        inputs["steps"][name] = {"params": params, "paired": paired,
                                 "batch": batch, "eps": eps}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if sharded:
            jmesh = make_mesh(WORLD)
            engine = JEngine(jtask, jmesh, donate=False)
            assert engine._use_shard_map
            st, m = engine.train_step(replicate_state(state, jmesh),
                                      jax_shard_batch(batch, jmesh))
        else:
            st, m = _with_eps(jtask.train_step)(
                state, jb, [jnp.asarray(e) for e in eps])
        want[f"step/{name}"] = ({k: float(v) for k, v in m.items()},
                                np_tree(st.params))
    jtask, state, params = _jax_task("cyclevaegan", False)
    batch = {k: rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
             for k in ("x", "y")}
    n_eps = len(cases.task_for("cyclevaegan", params, False).eval_passes)
    eps = [rng.randn(BATCH, IMAGE // 16, IMAGE // 16, LATENT).astype(
        np.float32) for _ in range(n_eps)]
    inputs["eval"] = {"params": params, "batch": batch, "eps": eps}
    jm = _with_eps(lambda s, b: jtask.eval_step(s, b, jax.random.PRNGKey(1)))(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        [jnp.asarray(e) for e in eps])
    want["eval/cyclevaegan"] = {k: np.asarray(v) for k, v in jm.items()}

    tmp = tmp_path_factory.mktemp("dp")
    torch.save(inputs, tmp / "inputs.pt")
    t0 = time.perf_counter()
    assert mesh.spawn(cases.run_rank, WORLD, "cpu", str(tmp / "inputs.pt"),
                      str(tmp)) == WORLD
    print(f"{WORLD} gloo ranks: {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        one = cases.run_cases(inputs, 0, 1, None)
    torch.set_num_threads(threads)
    yield ranks, one, want, tmp / "inputs.pt"


def _close(got, want, rtol, atol=1e-6):
    return abs(got - want) <= rtol * abs(want) + atol


def _check_states(got, want, atol):
    """Parameters and buffers within `atol`; Adam's counts equal, its
    moments (the gradient and its square) within MOMENT_RTOL relative L2
    per tensor (+1e-5: the biases ahead of an InstanceNorm, whose gradient
    is rounding noise)."""
    assert set(got) == set(want)
    for key, value in want.items():
        if key.endswith("/step"):
            assert torch.equal(got[key], value), key
        elif key.startswith("sd/"):
            assert float((got[key] - value).abs().max()) <= atol, key
        else:
            assert float(torch.linalg.vector_norm(got[key] - value)) <= (
                MOMENT_RTOL * float(torch.linalg.vector_norm(value)) + 1e-5
            ), key


@pytest.mark.parametrize("name", list(STEPS))
def test_ranks_step_matches_one_process_and_jax(sides, name):
    """N = 2 ranks, one step (tests/test_parallel.py:57-58 and :170): the
    ranks' meaned metrics and their update against the one-process step
    over the global batch and against JAX's step."""
    ranks, one, want, _ = sides
    key = f"step/{name}"
    got = ranks[0][key]
    assert got["metrics"]["nan_detected"] == 0.0
    for k, v in one[key]["metrics"].items():
        assert _close(got["metrics"][k], v, STEP_RTOL), k
    _check_states(got["state"], one[key]["state"], STATE_ATOL)

    jm, jparams = want[key]
    assert set(got["metrics"]) == set(jm)
    for k, v in jm.items():
        assert _close(got["metrics"][k], v, JAX_RTOL, 1e-5), k
    sd = {k[3:]: v.numpy() for k, v in got["state"].items()
          if k.startswith("sd/")}
    params, _ = torch_import.import_reference_state_dict(name, sd)
    worst, flipped, n = 0.0, 0, 0
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(jparams)):
        d = np.abs(a - b)
        worst, flipped, n = (max(worst, float(d.max())),
                             flipped + int((d > LR).sum()), n + d.size)
    assert worst <= 2 * LR + 1e-6
    assert flipped / n <= FLIPPED[name], flipped / n


@pytest.mark.parametrize("key", ["step/autoencoder", "step/vae",
                                 "step/aegan", "step/cyclevaegan",
                                 "twice/cyclevaegan", "drawn/vae",
                                 "ragged/vae", "epoch/vae"])
def test_ranks_stay_bitwise_equal(sides, key):
    """Every parameter, buffer (the discriminators' spectral u and v) and
    Adam state of the two ranks bit for bit, after one step, a second, and
    an epoch."""
    ranks, _, _, _ = sides
    a, b = ranks[0][key]["state"], ranks[1][key]["state"]
    assert set(a) == set(b) and any(k.endswith("exp_avg") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if "metrics" in ranks[0][key]:
        assert ranks[0][key]["metrics"] == ranks[1][key]["metrics"]


def test_drawn_noise_is_the_global_draw(sides):
    """Without eps, each rank draws the global batch's noise from its
    generator and keeps its rows (dp_normal): the same step as one process
    drawing the global batch's noise from the same seed."""
    ranks, one, _, _ = sides
    got, want = ranks[0]["drawn/vae"], one["drawn/vae"]
    for k, v in want["metrics"].items():
        assert _close(got["metrics"][k], v, STEP_RTOL), k
    _check_states(got["state"], want["state"], STATE_ATOL)
    # a rank drawing only its own rows would differ well beyond that
    assert got["metrics"]["loss_kl"] == pytest.approx(
        want["metrics"]["loss_kl"], rel=STEP_RTOL)


def test_ragged_batch_is_replicated(sides):
    """A global batch of 3 on 2 ranks: each rank computes the whole batch
    (its noise drawn unsliced), and the step is the one-process step, bit
    for bit on the CPU (the mean of two equal gradients is exact)."""
    ranks, one, _, _ = sides
    for r in ranks:
        assert r["ragged/vae"]["replicated"] and r["ragged/vae"]["rows"] == 3
    got, want = ranks[0]["ragged/vae"], one["ragged/vae"]
    assert not want["replicated"] and want["rows"] == 3
    assert got["metrics"] == want["metrics"]
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k


def test_shard_rows_rule_and_one_warning():
    """The rule of mesh.shard_rows: equal contiguous shards where the group
    divides the batch, else the whole batch, with one warning (worded as
    the JAX package's)."""
    assert [mesh.shard_rows(8, r, 4) for r in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    mesh._warned_replicated_batch = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert mesh.shard_rows(5, 1, 2) == (0, 5)
        assert mesh.shard_rows(5, 0, 2) == (0, 5)
    warned = [w for w in caught if issubclass(w.category, RuntimeWarning)
              and "REPLICATED" in str(w.message)]
    assert len(warned) == 1
    assert "data parallelism is forfeited" in str(warned[0].message)
    part, replicated = mesh.shard_batch({"x": np.zeros((6, 2))}, 2, 3)
    assert part["x"].shape == (2, 2) and not replicated


def test_nan_on_one_rank_skips_every_rank(sides):
    """A NaN in rank 1's shard only: the all-reduced loss is NaN on both
    ranks, so both skip the update (parameters, buffers and Adam unchanged)
    and report nan_detected."""
    ranks, _, _, _ = sides
    for r in ranks:
        assert r["nan/vae"]["unchanged"]
        assert r["nan/vae"]["metrics"]["nan_detected"] == 1.0
        assert np.isnan(r["nan/vae"]["metrics"]["G_loss"])


def test_a_stop_on_one_rank_stops_every_rank(sides):
    """utils.preempt.AgreedStop: a signal seen on rank 1 only becomes every
    rank's stop at the same poll (the step boundary), so the primary saves
    after the same step every rank took."""
    ranks, _, _, _ = sides
    for r in ranks:
        assert r["stop"] == {"first": False, "second": True,
                             "requested": True}


def test_eval_and_generate_gather_the_global_batch(sides):
    """eval_step's metrics meaned and its images, and generate's, gathered
    in rank order (tests/test_parallel.py:238): the one-process images bit
    for bit, the metrics within STEP_RTOL, and JAX's within its one-step
    bounds."""
    ranks, one, want, _ = sides
    got, ref = ranks[0]["eval/cyclevaegan"], one["eval/cyclevaegan"]
    for k in ("Gx", "Fy", "generate"):
        assert got[k].shape == (BATCH, IMAGE, IMAGE, 3)
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(ranks[1]["eval/cyclevaegan"][k], got[k]), k
    for k, v in ref["metrics"].items():
        assert _close(got["metrics"][k], v, STEP_RTOL), k
    jm = want["eval/cyclevaegan"]
    for k, v in got["metrics"].items():
        assert _close(v, float(jm[k]), JAX_RTOL, 1e-5), k
    families = importlib.import_module("torch_families")
    for k in ("Gx", "Fy"):
        a, b = got[k].numpy(), jm[k]
        assert np.abs(a - b).max() <= families.IMAGE_MAX_SHARE * np.abs(
            b).max()


def test_engine_epoch_means_match_one_process(sides):
    """One engine epoch and a validation pass over a sharded loader
    (tests/test_parallel.py:282): 4 + 4 sharded, 3 replicated; the meaned
    metrics against one process over the unsharded loader, and the
    validation images gathered to the global last batch."""
    ranks, one, _, _ = sides
    got, want = ranks[0]["epoch/vae"], one["epoch/vae"]
    assert got["replicated"] == [False, False, True]
    assert want["replicated"] == [False, False, False]
    for name, rtol in (("comps", EPOCH_RTOL), ("val_comps", VAL_RTOL)):
        assert set(got[name]) == set(want[name])
        for k, v in want[name].items():
            if k != "images_per_sec":
                assert _close(got[name][k], v, rtol), (name, k)
    assert got["comps"]["images_per_sec"] > 0
    assert got["gx"].shape == got["x"].shape == (3, IMAGE, IMAGE, 3)
    np.testing.assert_array_equal(got["x"], want["x"])


def test_make_group_refuses_more_devices_than_visible():
    """No quiet world 1: more CUDA devices than visible raises, as
    make_mesh does; the CPU hosts any rank count."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA device"):
        parallel.resolve_devices(n + 1, "cuda")
    assert parallel.resolve_devices(3, "cpu") == 3
    assert parallel.resolve_devices(None, "cpu") == 1
    with pytest.raises(ValueError):
        parallel.resolve_devices(0, "cpu")


def test_init_from_env_names_what_is_missing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        parallel.init_from_env("cpu")


def test_outside_a_scope_nothing_moves():
    """sync, dp_normal and gather are the plain operations outside a
    data-parallel scope (the default single-device path)."""
    t = [torch.ones(3), torch.zeros(2, dtype=torch.bfloat16)]
    assert parallel.sync(t)[0] is t[0] and parallel.dp_group() is None
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    assert torch.equal(parallel.dp_normal(g1, (2, 3), "cpu"),
                       torch.randn((2, 3), generator=g2))
    assert parallel.gather(t[0]) is t[0]
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_primary()


def test_four_ranks_cyclevaegan_step(sides, tmp_path):
    """The counterpart of __graft_entry__.py::dryrun_multichip: one
    cyclevaegan step at N = 4 (one sample a rank) against one process, the
    ranks bit for bit equal. Metrics within DRYRUN_RTOL (tests/
    test_parallel.py's cyclevaegan bound: its lambda_cycle = 10 terms
    amplify a change of summation order; measured 1.2e-5, total_loss);
    parameters and buffers within STATE_ATOL and at most FLIPPED's share
    of elements further apart than lr. The moments are not held here: on
    the CPU a batch of one takes another conv kernel, and this generator's
    f32 gradient is chaotic (ROADMAP.md queue 3: JAX's own f32 and f64
    gradients differ by 4-60% per tensor), so a one-sample rank's gradient
    leaves the batch's as far as f32 leaves f64;
    ``test_gradient_mean_is_exact_in_f64`` holds the mean itself."""
    _, one, _, inputs = sides
    mesh.spawn(cases.run_rank, 4, "cpu", str(inputs), str(tmp_path),
               ("cyclevaegan",))
    four = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    got, want = four[0]["step/cyclevaegan"], one["step/cyclevaegan"]
    for k, v in want["metrics"].items():
        assert _close(got["metrics"][k], v, DRYRUN_RTOL), k
    moved = n = 0
    for k, v in want["state"].items():
        if k.startswith("sd/"):
            d = (got["state"][k] - v).abs()
            assert float(d.max()) <= STATE_ATOL, k
            moved, n = moved + int((d > LR).sum()), n + d.numel()
    assert moved / n <= FLIPPED["cyclevaegan"], moved / n
    for r in four[1:]:
        for k, v in got["state"].items():
            assert torch.equal(r["step/cyclevaegan"]["state"][k], v), k


def test_gradient_mean_is_exact_in_f64(monkeypatch):
    """What the ranks' all_reduce computes, the mean of per-shard
    gradients, is the global batch's gradient: in f64 (the task and its
    inputs widened) the mean of four one-sample cyclevaegan steps' first
    moments equals the four-sample step's to 1e-12 relative L2 per
    tensor."""
    from vae_cyclegan_tpu_torch.config import ModelConfig
    from vae_cyclegan_tpu_torch.models.tasks import create_task
    from vae_cyclegan_tpu_torch.models.tasks.base import Task

    f64 = torch.float64
    monkeypatch.setattr(Task, "_nchw", lambda self, images: torch.as_tensor(
        images).to(self.device, f64).permute(0, 3, 1, 2).contiguous())
    default = torch.get_default_dtype()
    torch.set_default_dtype(f64)
    try:
        rng = np.random.RandomState(0)
        batch = {k: rng.rand(4, IMAGE, IMAGE, 3) for k in ("x", "y")}
        eps = [rng.randn(4, IMAGE // 16, IMAGE // 16, LATENT)
               for _ in range(6)]

        def moments(rows):
            task = create_task("cyclevaegan", model=ModelConfig(
                IMAGE, LATENT, BASE, f64), paired=False, device="cpu")
            task.init(0)
            task.nets.to(f64)
            task.train_step({k: v[rows] for k, v in batch.items()},
                            eps=[e[rows] for e in eps])
            return [task.opt_g.state[p]["exp_avg"] for p in task.gen_params]

        whole = moments(slice(0, 4))
        parts = [moments(slice(i, i + 1)) for i in range(4)]
    finally:
        torch.set_default_dtype(default)
    for j, w in enumerate(whole):
        mean = sum(p[j] for p in parts) / 4
        assert float((mean - w).norm()) <= 1e-12 * float(w.norm()) + 1e-30


def test_spawned_ranks_import_no_jax():
    """The ranks run torch_parallel_cases, which imports torch and the port
    only (this process has JAX loaded; the ranks are spawned, not forked)."""
    import ast

    src = open(os.path.join(os.path.dirname(__file__),
                            "torch_parallel_cases.py")).read()
    imported = {a.name.split(".")[0] for node in ast.walk(ast.parse(src))
                if isinstance(node, ast.Import) for a in node.names}
    imported |= {node.module.split(".")[0] for node in ast.walk(ast.parse(
        src)) if isinstance(node, ast.ImportFrom) and node.module}
    assert not imported & {"jax", "jaxlib", "flax", "vae_cyclegan_tpu"}
