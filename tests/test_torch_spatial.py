"""Spatial parallelism of the port (``vae_cyclegan_tpu_torch/parallel/
spatial.py``) on the CPU over gloo, against the port's one process and the
JAX package (the counterparts of tests/test_parallel.py's spatial cases,
which run JAX's GSPMD lowering on conftest's virtual CPU devices).

Two ranks (one data group, a spatial group of 2) are spawned once for the
file (``parallel.mesh.spawn``, start method ``spawn``: this process has JAX
loaded with its threads), and each runs every case of
``torch_spatial_cases.run_cases``; this process runs the same cases under a
spatial scope of 1 (``parallel.spatial.single()``, the same formulas with
no exchange), the plain one-process steps, and the JAX side. Weights: the
JAX task's initial state (``params_from_jax``). Small size: image 32, base
8, latent 8, f32, one torch thread a process, global batch 2.

Comparisons and tolerances (measured values in brackets):

* the ops (k3, k7, k4 s2 halo convs, the 1-row bottleneck shard, the
  K3/K4 strips at the head, U4 and the tail; the split InstanceNorm; the
  discriminator's whole-map conv): the ranks' rows, gathered, against the
  one-process op and its autograd gradients (dx rows, dw summed over the
  ranks), within 1e-5 of the largest value (f32 sums in another order)
  [at most 1.1e-6 of it];
* (a) a train step on the ranks against this process under a spatial scope
  of 1 (so only the sharding differs): every parameter and buffer within
  5e-4 (tests/test_torch_parallel.py's bar) [4.0e-4: biases ahead of an
  InstanceNorm, whose exact gradient is zero, flip their first Adam step];
  every metric within 1e-5 relative + ROUNDING_FACTOR = 10 times that
  metric's own f32 rounding, |f32 - f64| of the scope-of-1 step (+1e-6)
  [at most 0.18 of that bar, cyclevaegan's D_loss; the largest relative
  gap 1.7e-4, its D_loss_x_fake; over five other draws of the inputs at
  most 0.80 of it]. Adam's moments are held in f64 only (below): in f32 at
  image 32 no leaf is resolved to 1e-3. The generator's leaves take L1's
  sign, so an output element within the forward's rounding of its target
  flips and moves every generator leaf by 1-2% (one element of 6,144 in
  one of six draws of the inputs); biases ahead of an InstanceNorm have a
  zero exact gradient, so their moments are rounding noise; the
  discriminators' leaves read up to 2.1e-3;
* (b) the scope of 1 against the plain one-process step (only the
  formulas differ: single-pass InstanceNorm statistics, the strips) and
  (c) the ranks against JAX (autoencoder and vae: JAX's own
  ``make_mesh(2, spatial=2)`` GSPMD step; cyclevaegan: JAX's one-device
  step with the same noise): tests/torch_families.py's one-step bars,
  every metric within 1e-3 relative (+1e-5), every parameter within one
  Adam quantum (2 lr + 1e-6), and at most the family's share of elements
  further apart than lr;
* in f64 (the task, its inputs and ``Tensor.float()`` widened), for each
  family: the ranks' step against the scope of 1 within 1e-10 relative on
  every metric, 1e-6 on every parameter and 1e-3 relative L2 (+1e-5) on
  every Adam moment [metrics 4.4e-13, parameters 6.8e-8: Adam's first step
  divides a gradient by its own magnitude]: the sharding is exact, and
  what (a) reads in f32 is f32 rounding;
* the ranks' parameters, buffers and Adam states bit for bit equal; the
  gathered eval_step and generate images within 1e-3 of the largest image
  value of the scope of 1 (tests/torch_families.py's IMAGE_MAX_SHARE);
  remat's step against the ranks' plain step, and the 2 x 2 = 4 rank
  autoencoder step against one process: metrics within 1e-5 relative
  (+1e-6), parameters within 5e-4 (and remat's moments within 1e-3).
"""

import importlib
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spatial_cases as cases
from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu.parallel import make_mesh, replicate_state
from vae_cyclegan_tpu.parallel import shard_batch as jax_shard_batch
from vae_cyclegan_tpu.parallel.dp import eps_queue
from vae_cyclegan_tpu.utils import torch_import
from vae_cyclegan_tpu_torch.engine import Engine
from vae_cyclegan_tpu_torch.models.networks import SpectralConv
from vae_cyclegan_tpu_torch.ops import instance_norm as inn
from vae_cyclegan_tpu_torch.parallel import mesh, spatial
from vae_cyclegan_tpu_torch.utils.jax_import import params_from_jax

IMAGE, BASE, LATENT, BATCH, S = 32, 8, 8, 2, 2
LR = 2e-4
STEP_RTOL, STATE_ATOL, MOMENT_RTOL = 1e-5, 5e-4, 1e-3
#: (a)'s metric bar beyond STEP_RTOL: this many times the metric's own f32
#: rounding, |f32 - f64| of the scope-of-1 step
ROUNDING_FACTOR = 10
DRYRUN_RTOL = 5e-4
JAX_RTOL = 1e-3
OP_SHARE = 1e-5
F64_RTOL, F64_ATOL = 1e-10, 1e-6
IMAGE_MAX_SHARE = 1e-3
#: tests/test_torch_families_*.py's shares of elements further than lr
FLIPPED = {"autoencoder": 0.03, "vae": 0.01, "cyclevaegan": 0.04}
#: each step case: paired, and whether JAX runs its GSPMD spatial step
#: (else its one-device step with the same noise)
STEPS = {"autoencoder": (True, True), "vae": (True, True),
         "cyclevaegan": (False, False)}

jin = importlib.import_module("vae_cyclegan_tpu.ops.instance_norm")


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


def _op_inputs(rng):
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    convs = []
    for _, xs, ws, stride, pad, _ in cases.CONV_CASES:
        y = cases.conv_reference(torch.zeros(xs), torch.zeros(ws), stride,
                                 pad)
        convs.append((t(*xs), t(*ws) * 0.2, t(*y.shape)))
    ins = [(t(*shape) * 2 + 0.5, t(*shape)) for shape, *_ in cases.IN_CASES]
    sc = SpectralConv(16, 1, 4)
    sc.reset_parameters(torch.Generator().manual_seed(1))
    return {"convs": convs, "in": ins,
            "spectral": {"sd": {k: v.clone() for k, v in
                                sc.state_dict().items()},
                         "x": t(2, 16, 4, 4)}}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(the ranks' results, the scope-of-1 results, the plain one-process
    steps, JAX's steps, the inputs, the inputs' file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    inputs = {"spatial": S, "steps": {}, **_op_inputs(rng)}
    want = {}
    for name, (paired, gspmd) in STEPS.items():
        jtask, state, params = _jax_task(name, paired)
        batch = {k: rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
                 for k in ("x", "y")}
        n_eps = len(cases.task_for(name, params, paired).train_passes)
        eps = [rng.randn(BATCH, IMAGE // 16, IMAGE // 16, LATENT).astype(
            np.float32) for _ in range(n_eps)]
        inputs["steps"][name] = {"params": params, "paired": paired,
                                 "batch": batch, "eps": eps}
        if gspmd:
            jmesh = make_mesh(S, spatial=S)
            st, m = _with_eps(jtask.train_step)(
                replicate_state(state, jmesh), jax_shard_batch(batch, jmesh),
                [jnp.asarray(e) for e in eps])
        else:
            st, m = _with_eps(jtask.train_step)(
                state, {k: jnp.asarray(v) for k, v in batch.items()},
                [jnp.asarray(e) for e in eps])
        want[name] = ({k: float(v) for k, v in m.items()},
                      np_tree(st.params))
    _, _, params = _jax_task("cyclevaegan", False)
    batch = {k: rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
             for k in ("x", "y")}
    n_eps = len(cases.task_for("cyclevaegan", params, False).eval_passes)
    inputs["eval"] = {"params": params, "batch": batch, "eps": [
        rng.randn(BATCH, IMAGE // 16, IMAGE // 16, LATENT).astype(np.float32)
        for _ in range(n_eps)]}

    tmp = tmp_path_factory.mktemp("sp")
    torch.save(inputs, tmp / "inputs.pt")
    t0 = time.perf_counter()
    assert mesh.spawn(cases.run_rank, S, "cpu", str(tmp / "inputs.pt"),
                      str(tmp)) == S
    print(f"{S} gloo ranks: {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(S)]
    one = cases.run_cases(inputs, None)
    plain = {}
    for name, case in inputs["steps"].items():
        task = cases.task_for(name, case["params"], case["paired"])
        m = Engine(task, seed=0).train_step(
            {k: torch.from_numpy(v) for k, v in case["batch"].items()},
            eps=case["eps"] or None)
        plain[name] = {"metrics": cases.floats(m),
                       "state": cases.snapshot(task)}
    torch.set_num_threads(threads)
    yield ranks, one, plain, want, inputs, tmp / "inputs.pt"


def _close(got, want, rtol, atol=1e-6):
    return abs(got - want) <= rtol * abs(want) + atol


def _check_states(got, want, atol, moments=None):
    """Parameters and buffers within `atol`; Adam's counts equal; where
    `moments` is given, its moments within that relative L2 per tensor
    (+1e-5)."""
    assert set(got) == set(want)
    for key, value in want.items():
        if key.endswith("/step"):
            assert torch.equal(got[key], value), key
        elif key.startswith("sd/"):
            assert float((got[key] - value).abs().max()) <= atol, key
        elif moments is not None:
            assert float(torch.linalg.vector_norm(got[key] - value)) <= (
                moments * float(torch.linalg.vector_norm(value)) + 1e-5
            ), key


def _within_share(got, want, share):
    return float((got - want).abs().max()) <= share * float(
        want.abs().max()) + 1e-7


def _gathered(ranks, key, idx, dim=2):
    return torch.cat([r[key][idx] for r in ranks], dim=dim)


def test_ranks_form_one_spatial_group(sides):
    ranks = sides[0]
    assert [r["layout"] for r in ranks] == [(S, 0, 1, 0), (S, 1, 1, 0)]


@pytest.mark.parametrize("case", cases.CONV_CASES, ids=lambda c: c[0])
def test_halo_conv_matches_one_process(sides, case):
    """Each rank's output rows, its dx rows and the ranks' summed dw of the
    halo conv (neighbours' rows inside, reflect rows at the true borders)
    and of the K3/K4 strip, against the one-process reflect conv."""
    ranks, _, _, _, inputs, _ = sides
    name, _, _, stride, pad, _ = case
    x, w, g = inputs["convs"][cases.CONV_CASES.index(case)]
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    y = cases.conv_reference(x, w, stride, pad)
    y.backward(g)
    key = f"conv/{name}"
    assert _within_share(_gathered(ranks, key, 0), y.detach(), OP_SHARE)
    assert _within_share(_gathered(ranks, key, 1), x.grad, OP_SHARE)
    assert _within_share(sum(r[key][2] for r in ranks), w.grad, OP_SHARE)


@pytest.mark.parametrize("case", cases.IN_CASES,
                         ids=lambda c: f"{c[3]}-{c[1]}-{c[2]}")
def test_split_instance_norm_matches_one_process(sides, case):
    """The split InstanceNorm (this rank's sums, their all-reduce, the apply
    with the global count) and its backward (two all-reduced means) against
    ``tiled_reference`` over the whole plane and its autograd gradient."""
    ranks, _, _, _, inputs, _ = sides
    shape, act, order, mode = case
    x, g = inputs["in"][cases.IN_CASES.index(case)]
    x = x.clone().requires_grad_(True)
    y = inn.tiled_reference(x, act, order)
    y.backward(g)
    key = f"in/{mode}/{act}"
    assert _within_share(_gathered(ranks, key, 0), y.detach(), OP_SHARE)
    assert _within_share(_gathered(ranks, key, 1), x.grad, OP_SHARE)


def test_spectral_conv_partial_sum(sides):
    """The discriminator's whole-map conv: each rank's rows against its
    rows of the normalized weight, summed over the group, the bias once;
    the power iteration replicated. Each rank's loss is the full (replicated)
    score, so the ranks' gradients sum to S times the one-process gradient
    (``parallel.spatial``'s invariant; ``sync``'s world mean divides by
    it)."""
    ranks, _, _, _, inputs, _ = sides
    sc = SpectralConv(16, 1, 4)
    sc.load_state_dict(inputs["spectral"]["sd"])
    x = inputs["spectral"]["x"].clone().requires_grad_(True)
    y = sc(x, update_stats=True)
    y.sum().backward()
    for r in ranks:
        assert _within_share(r["spectral"][0], y.detach(), OP_SHARE)
        assert torch.equal(r["spectral"][4], sc.weight_u)
    assert _within_share(_gathered(ranks, "spectral", 1), S * x.grad,
                         OP_SHARE)
    for i, want in ((2, sc.weight_orig.grad), (3, sc.bias.grad)):
        assert _within_share(sum(r["spectral"][i] for r in ranks), S * want,
                             OP_SHARE)


@pytest.mark.parametrize("act,order", [
    ("relu", "act_norm"), ("leaky_relu", "norm_act"), ("tanh", "act_norm"),
    ("identity", "act_norm")])
def test_split_plain_versions_match_jax_two_pallas_calls(act, order):
    """``in_stats_reference`` then ``in_apply_reference`` (the plain
    versions of the split kernels) against JAX's ``_pallas_in_act_tiled``,
    its ``_stats_kernel`` and ``_apply_kernel`` pallas_calls in interpret
    mode, at a tiled site's shape (two row tiles) and its 2x2 edge:
    tests/test_torch_tiled.py's bar, rtol and atol 1e-5 [at most 1.8e-5
    absolute, tanh at 2x2: one ulp of tanh over a tiny variance]."""
    rng = np.random.RandomState(3)
    for shape in ((2, 64, 32, 32), (2, 16, 2, 2)):
        x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
        want = np.asarray(jin._pallas_in_act_tiled(
            jnp.asarray(x.transpose(0, 2, 3, 1)), act, order, 1e-5,
            interpret=True)).transpose(0, 3, 1, 2)
        xt = torch.from_numpy(x)
        hw = shape[2] * shape[3]
        got, _ = inn.in_apply_reference(
            xt, inn.in_stats_reference(xt, act, order), float(hw), act,
            order)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, inn.tiled_reference(xt, act, order))


def _check_jax(got, name, want):
    jm, jparams = want[name]
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


def _check_one_step(got, want, name):
    """tests/torch_families.py's one-step bars between two port steps."""
    for k, v in want["metrics"].items():
        assert _close(got["metrics"][k], v, JAX_RTOL, 1e-5), k
    moved = n = 0
    for k, v in want["state"].items():
        if k.startswith("sd/"):
            d = (got["state"][k] - v).abs()
            assert float(d.max()) <= 2 * LR + 1e-6, k
            moved, n = moved + int((d > LR).sum()), n + d.numel()
    assert moved / n <= FLIPPED[name], moved / n


@pytest.mark.parametrize("against", ["one_process", "plain", "jax"])
@pytest.mark.parametrize("name", list(STEPS))
def test_spatial_step(sides, name, against):
    """A 1 x 2 spatial train step: (a) the ranks against this process under
    a spatial scope of 1, (b) that scope against the plain step, (c) the
    ranks against JAX (the module docstring's bars)."""
    ranks, one, plain, want, _, _ = sides
    key = f"step/{name}"
    got = ranks[0][key]
    assert got["metrics"]["nan_detected"] == 0.0
    if against == "one_process":
        exact = one[f"f64/{name}"]["metrics"]
        for k, v in one[key]["metrics"].items():
            bar = STEP_RTOL * abs(v) + ROUNDING_FACTOR * abs(v - exact[k])
            assert abs(got["metrics"][k] - v) <= bar + 1e-6, k
        _check_states(got["state"], one[key]["state"], STATE_ATOL)
    elif against == "plain":
        _check_one_step(one[key], plain[name], name)
    else:
        _check_jax(got, name, want)


@pytest.mark.parametrize("name", list(STEPS))
def test_spatial_step_is_exact_in_f64(sides, name):
    """In f64 the sharded step is the scope-of-1 step to rounding: what (a)
    reads in f32 is f32 rounding, not the sharding."""
    ranks, one, _, _, _, _ = sides
    got, ref = ranks[0][f"f64/{name}"], one[f"f64/{name}"]
    assert got["metrics"]["nan_detected"] == 0.0
    for k, v in ref["metrics"].items():
        assert _close(got["metrics"][k], v, F64_RTOL, 1e-12), k
    _check_states(got["state"], ref["state"], F64_ATOL, MOMENT_RTOL)


@pytest.mark.parametrize("key", ["step/autoencoder", "step/vae",
                                 "step/cyclevaegan", "remat/cyclevaegan",
                                 "drawn/vae"])
def test_ranks_stay_bitwise_equal(sides, key):
    """Every parameter, buffer and Adam state of the two ranks bit for bit
    (the gradient mean gives every rank the same update) and the same
    meaned metrics."""
    ranks = sides[0]
    a, b = ranks[0][key]["state"], ranks[1][key]["state"]
    assert set(a) == set(b) and any(k.endswith("exp_avg") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert ranks[0][key]["metrics"] == ranks[1][key]["metrics"]


def test_remat_with_spatial(sides):
    """--remat under spatial parallelism: the recompute re-enters the halo
    exchanges and all-reduces in the same order on every rank; the step is
    the ranks' plain step within the module docstring's bars."""
    ranks = sides[0]
    got, ref = ranks[0]["remat/cyclevaegan"], ranks[0]["step/cyclevaegan"]
    for k, v in ref["metrics"].items():
        assert _close(got["metrics"][k], v, STEP_RTOL), k
    _check_states(got["state"], ref["state"], STATE_ATOL, MOMENT_RTOL)


def test_drawn_noise_is_the_global_draw(sides):
    """Without eps, each rank draws the global array's noise and keeps its
    rows (``dp_normal``): the scope-of-1 step drawing from the same seed."""
    ranks, one, _, _, _, _ = sides
    got, want = ranks[0]["drawn/vae"], one["drawn/vae"]
    for k, v in want["metrics"].items():
        assert _close(got["metrics"][k], v, STEP_RTOL), k
    _check_states(got["state"], want["state"], STATE_ATOL)


def test_eval_and_generate_gather_the_images(sides):
    """eval_step's images and generate's gathered along H then along the
    batch: the whole images on every rank, as the scope of 1 computes
    them."""
    ranks, one, _, _, _, _ = sides
    ref = one["eval/cyclevaegan"]
    for k in ("Gx", "Fy", "generate"):
        got = ranks[0]["eval/cyclevaegan"][k]
        assert got.shape == (BATCH, IMAGE, IMAGE, 3)
        assert torch.equal(ranks[1]["eval/cyclevaegan"][k], got), k
        assert _within_share(got, ref[k], IMAGE_MAX_SHARE), k
    for k, v in ref["metrics"].items():
        assert _close(ranks[0]["eval/cyclevaegan"]["metrics"][k], v,
                      DRYRUN_RTOL), k


def test_four_ranks_2x2_autoencoder_step_and_refusal(sides, tmp_path):
    """2 data x 2 spatial ranks, one autoencoder step (one sample a data
    rank) against the scope of 1 within the module docstring's bars, the
    ranks bit for bit equal; then a spatial group of 4 at image 32, whose D4 block would
    unshuffle a 1-row shard: it raises, naming the site and image 64."""
    _, one, _, _, _, inputs = sides
    mesh.spawn(cases.run_rank, 4, "cpu", str(inputs), str(tmp_path),
               ("autoencoder",))
    four = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    assert [r["layout"] for r in four] == [
        (2, 0, 2, 0), (2, 1, 2, 0), (2, 0, 2, 1), (2, 1, 2, 1)]
    got, want = four[0]["step/autoencoder"], one["step/autoencoder"]
    for k, v in want["metrics"].items():
        assert _close(got["metrics"][k], v, STEP_RTOL), k
    _check_states(got["state"], want["state"], STATE_ATOL)
    for r in four[1:]:
        for k, v in got["state"].items():
            assert torch.equal(r["step/autoencoder"]["state"][k], v), k
    mesh.spawn(cases.refusal, 4, "cpu", IMAGE, 4, str(tmp_path))
    for r in range(4):
        msg = torch.load(tmp_path / f"refusal{r}.pt", weights_only=False)
        assert msg is not None and "pixel unshuffle" in msg, msg
        assert "smallest that works at --spatial 4 is 64" in msg


def test_refusals_and_one_warning(monkeypatch):
    """JAX's refusals and its one-time warning: a spatial size that does
    not divide the ranks, spatial sharding across hosts, and a height that
    does not divide the group (replicated over it, one warning)."""
    with pytest.raises(ValueError, match="does not divide"):
        mesh.make_spatial(2)
    with pytest.raises(ValueError, match=">= 1"):
        mesh.make_spatial(0)
    with pytest.raises(NotImplementedError, match="single-host"):
        mesh.make_spatial(2, multihost=True)
    assert mesh.make_spatial(1) == spatial.single()
    monkeypatch.setattr(mesh, "_warned_replicated_spatial", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert mesh.shard_height(30, 1, 4) == (0, 30)
        assert mesh.shard_height(30, 0, 4) == (0, 30)
        assert mesh.shard_height(32, 1, 4) == (8, 16)
    warned = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(warned) == 1
    assert "spatial parallelism is forfeited" in str(warned[0].message)
    lay = spatial.Layout(4, 2, None, 1, 0, None)
    part, rep = mesh.shard_spatial({"x": torch.zeros(2, 32, 8, 3),
                                    "i": torch.zeros(2)}, lay)
    assert part["x"].shape == (2, 8, 8, 3) and not rep
    assert part["i"].shape == (2,)


def test_outside_a_scope_nothing_moves():
    """spatial_sum, halo and gather_rows outside a scope: the sum and the
    gather are the tensor, the halo the reflect padding of the rows."""
    t = torch.randn(2, 3, 6, 5)
    assert spatial.spatial_sum(t) is t and spatial.gather_rows(t) is t
    assert spatial.current() is None and spatial.spatial_size() == 1
    assert torch.equal(spatial.halo(t, 2, 1), torch.nn.functional.pad(
        t, (0, 0, 2, 1), mode="reflect"))
