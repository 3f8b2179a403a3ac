"""Multi-step trajectory parity of the port against the JAX package
(vae_cyclegan_tpu_torch/parity_curves.py, ROADMAP.md queue 1, item 11).

Each family trains 8 steps on both sides from the same weights (the JAX
task's initial state, carried into the port by ``params_from_jax``), on
the same batches and the same recorded noise (``parity_curves.
trajectory_inputs``: ``scripts/parity_curves.py``'s protocol; ``eps_queue``
on the JAX side, ``train_step(..., eps=...)`` in the port): f32 on the CPU,
image 32, base 8, latent 8, batch 2. JAX runs its plain XLA lowering, the
port its kernels' plain versions.

The bar is the one users were promised (``BASELINE.json``: loss parity
within 2%), held as the JAX package held it against the reference
(``scripts/parity_curves.py``: the ``G_loss`` curve), on trajectory means,
not points: after the first update the f32 gradient is chaotic at random
weights (ROADMAP.md, queue 3, limits), so single steps wander while the
curves' means agree. The mean of ``G_loss`` over the 8 steps within 2% of
JAX's, every value finite, no update skipped. ``D_loss`` (the adversarial
families) is finite and its first step, before any update, within the
one-step tolerance; its trajectory mean is printed and not held to 2%: at
this size it is chaos, not the port (JAX against its own one-ulp twin
moves it 5.9% for cyclevaegan; ROADMAP.md queue 3 has the numbers, as the
JAX package's own cyclevaegan curve missed the reference's D_loss mean by
8.7% in ``docs/parity_curves.json``). torch runs on one thread, so the
port's trajectory does not depend on the machine's core count (its sums
are split over the intra-op threads, and the chaos amplifies that: 3% on
cyclevaegan's D_loss). autoencoder, vae and cyclevaegan run in the gate;
the other seven families are ``slow``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu.parallel.dp import eps_queue
from vae_cyclegan_tpu_torch import parity_curves
from vae_cyclegan_tpu_torch.models.tasks import ARCHITECTURES
from vae_cyclegan_tpu_torch.utils.jax_import import params_from_jax

IMAGE, BASE, LATENT, BATCH, STEPS, SEED = 32, 8, 8, 2, 8, 0
BAR = 0.02
# tests/torch_families.py's METRIC_RTOL: one step from the same state
FIRST_STEP_RTOL = 1e-3
GATE = ("autoencoder", "vae", "cyclevaegan")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_trajectory(name, twin=False):
    """(the JAX task's initial weights as a port state_dict, its per-step
    metrics, and with `twin` the metrics of the same run from every
    parameter one ulp up) over the protocol's batches and noise."""
    jtask = jax_create_task(name, model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE), paired=True)
    state = jax.jit(jtask.init_state)(jax.random.PRNGKey(SEED))
    params = params_from_jax(np_tree(state.params), np_tree(state.spectral))
    n_eps = len(ARCHITECTURES[name].train_passes)
    batches, eps = parity_curves.trajectory_inputs(STEPS, IMAGE, BATCH, SEED,
                                                   LATENT, n_eps)

    def run(st, b, e):
        with eps_queue(list(e)):
            return jtask.train_step(st, b)

    step = jax.jit(run)

    def trajectory(st):
        curves = {}
        for (x, y), e in zip(batches, eps):
            st, m = step(st, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                         [jnp.asarray(a) for a in e])
            for key, value in m.items():
                curves.setdefault(key, []).append(float(value))
        return curves

    bumped = None
    if twin:
        bumped = trajectory(state.replace(params=jax.tree_util.tree_map(
            lambda p: jnp.nextafter(p, jnp.inf), state.params)))
    return params, trajectory(state), bumped


def check_trajectory(name):
    adversarial = name in ("aegan", "vaegan", "cycleaegan", "cyclevaegan")
    params, want, jax_twin = jax_trajectory(name, twin=adversarial)
    got = parity_curves.run_trajectory(
        name, STEPS, IMAGE, BATCH, SEED, "cpu", torch.float32, "auto",
        params, base_width=BASE, latent_dim=LATENT)
    assert got["nan_detected"] == [0.0] * STEPS
    assert want["nan_detected"] == [0.0] * STEPS
    keys = [k for k in parity_curves.CURVES if k in want]
    assert keys == [k for k in parity_curves.CURVES if k in got]
    assert "G_loss" in keys and ("D_loss" in keys) == adversarial
    assert set(got["components"]) == set(want) - set(keys) - {"nan_detected"}
    gaps = {}
    for key in keys:
        assert len(got[key]) == len(want[key]) == STEPS
        assert np.isfinite(got[key]).all() and np.isfinite(want[key]).all()
        assert abs(got[key][0] - want[key][0]) <= FIRST_STEP_RTOL * abs(
            want[key][0]) + 1e-5, key
        gaps[key] = parity_curves.mean_gap(got[key], want[key])
    print(f"{name}: trajectory mean gaps to JAX {gaps}")
    if adversarial:  # the one-ulp bands D_loss is read against (printed)
        twin = parity_curves.run_trajectory(
            name, STEPS, IMAGE, BATCH, SEED, "cpu", torch.float32, "auto",
            params, base_width=BASE, latent_dim=LATENT, bump=0)
        print(f"{name}: one-ulp bands, port " + str({
            k: parity_curves.mean_gap(twin[k], got[k]) for k in keys})
            + ", JAX " + str({k: parity_curves.mean_gap(jax_twin[k], want[k])
                              for k in keys}))
    assert gaps["G_loss"] <= BAR, gaps
    return gaps


@pytest.mark.parametrize("name", GATE)
def test_trajectory_matches_jax(name):
    check_trajectory(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in ARCHITECTURES
                                  if n not in GATE])
def test_trajectory_matches_jax_slow(name):
    check_trajectory(name)


def test_trajectory_inputs_follow_the_harness_protocol():
    """The batches and noise are scripts/parity_curves.py's: the batches
    from RandomState(seed), x then y per step, drawn up front; the noise
    from RandomState(seed + 1), NCHW, `passes` a step, handed over NHWC."""
    batches, eps = parity_curves.trajectory_inputs(3, 32, 2, 5, 8, 2)
    rng = np.random.RandomState(5)
    for x, y in batches:
        np.testing.assert_array_equal(x, rng.rand(2, 32, 32, 3).astype(
            np.float32))
        np.testing.assert_array_equal(y, rng.rand(2, 32, 32, 3).astype(
            np.float32))
    rs = np.random.RandomState(6)
    for step in eps:
        assert len(step) == 2
        for e in step:
            want = rs.randn(2, 8, 2, 2).astype(np.float32)
            np.testing.assert_array_equal(e, want.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("seed", [None, 3])
def test_bump_one_ulp_moves_every_parameter_one_ulp(seed):
    """The chaos control: every parameter element one ulp up (no seed), or
    up or down by a seeded coin (both directions taken, the same coins for
    the same seed); nothing else moves (the spectral buffers stay)."""
    from vae_cyclegan_tpu_torch.config import ModelConfig
    from vae_cyclegan_tpu_torch.models.tasks import create_task

    def bumped():
        task = create_task("cyclevaegan", model=ModelConfig(32, 8, 8),
                           device="cpu")
        task.init(0)
        before = {k: v.clone() for k, v in task.state_dict().items()}
        parity_curves.bump_one_ulp(task, seed)
        return task, before

    task, before = bumped()
    params = dict(task.nets.named_parameters())
    ups = downs = 0
    for key, old in before.items():
        new = task.state_dict()[key]
        if key not in params:
            assert torch.equal(new, old), key
            continue
        up = new > old
        assert (up | (new < old)).all(), key
        want = np.where(up.numpy(), np.nextafter(old.numpy(), np.float32(
            np.inf)), np.nextafter(old.numpy(), np.float32(-np.inf)))
        np.testing.assert_array_equal(new.numpy(), want)
        ups, downs = ups + int(up.sum()), downs + int((~up).sum())
    assert ups > 0 and (downs > 0) == (seed is not None)
    again, _ = bumped()
    for key, value in task.state_dict().items():
        assert torch.equal(again.state_dict()[key], value), key


def test_run_labels():
    assert parity_curves.parse_run("bf16") == (torch.bfloat16, None)
    assert parity_curves.parse_run("f32_ulp") == (torch.float32, 0)
    assert parity_curves.parse_run("f32_ulp2") == (torch.float32, 2)
    for bad in ("f16", "f32_ulp0", "f32_up", "f32_ulpx"):
        with pytest.raises(ValueError):
            parity_curves.parse_run(bad)


def test_parity_curves_cli_on_the_cpu(tmp_path):
    """The CLI runs each configuration from one set of weights and writes
    the curves and gaps; the reference's gap to itself is not listed, and
    two runs of one configuration are the same curve."""
    out = tmp_path / "curves.json"
    assert parity_curves.main([
        "--platform", "cpu", "--archs", "vaegan", "--steps", "2",
        "--image_size", "32", "--base_width", "8", "--latent_dim", "8",
        "--runs", "f32", "f32_ulp", "f32_ulp1", "bf16", "--reference", "f32",
        "--out", str(out)]) == 0
    import json
    (rec,) = json.loads(out.read_text())
    assert rec["runs"] == ["f32", "f32_ulp", "f32_ulp1", "bf16"]
    assert set(rec["gaps"]) == {"f32_ulp", "f32_ulp1", "bf16"}
    assert set(rec["gaps"]["bf16"]) == {"G_loss", "D_loss"}
    for key in ("f32_G_loss", "f32_ulp_G_loss", "bf16_D_loss",
                "relative_gap", "max_relative_gap", "final_relative_gap",
                "component_max_relative_gap"):
        assert key in rec, key
    again = parity_curves.run_trajectory(
        "vaegan", 2, 32, 2, 0, "cpu", torch.float32, base_width=8,
        latent_dim=8)
    assert again["G_loss"] == rec["f32_G_loss"]
    with pytest.raises(SystemExit):
        parity_curves.main(["--platform", "cpu", "--runs", "bf16",
                            "--reference", "f32"])
