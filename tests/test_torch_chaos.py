"""The vaegan trajectory against JAX's, judged against its own chaos band
(ROADMAP.md queue 3, F1).

``tests/test_torch_trajectory.py`` holds each family's 8-step mean G_loss
within 2% of JAX's; vaegan misses that bar, and JAX misses it against its
own one-ulp twin too. This file settles whether that gap is chaos or a
defect. Configuration: the trajectory file's (f32 on the CPU, one torch
thread, image 32, base 8, latent 8, batch 2), 40 steps, from the JAX task's
initial weights, on the same batches and noise.

* The bisect (``test_vaegan_every_step_matches_jax_from_jax_state``): each
  of the 40 steps run by the port from JAX's state before it (parameters,
  spectral vectors, both Adams' moments and counts) against JAX's step:
  G_loss and D_loss within the one-step tolerance (1e-3), every other
  metric within 1e-2, the spectral vectors within 1e-6, and the update:
  every parameter within 10 lr of JAX's and at most 5% of the elements
  further apart than lr. A defect in the D pass, the spectral u update or
  the Adam update moves most elements or a loss well past these; rounding
  moves few (a near-zero gradient's sign, which Adam turns into a whole
  step). Measured over the 40 steps when written: G_loss 7.5e-5, D_loss
  2.1e-4, the loss terms 2.4e-3 (the discriminator's fake term, after the
  step's generator update; the KL term 1.0e-3 at step 17: it reads
  exp(logvar) of the 2x2 bottleneck planes, which InstanceNorm over four
  elements conditions badly), spectral 1.5e-8, parameters 1.14e-3.
* The band (``test_vaegan_gap_to_jax_against_the_chaos_band``), the
  protocol of ``scripts/vaegan_chaos_probe.py``: each side runs PROBES more
  trajectories, probe i with one element of weight tensor 7i + 1 (ndim >
  1) moved one ulp up; a side's band at step t is the largest of its
  probes' relative G_loss gaps to its own run, and ``band[t]`` the larger
  of the two sides'. The port's gap to JAX is printed against it point by
  point and by mean, beside a control: the port against itself with the
  tiled InstanceNorm (``instance_norm="tiled"``, the same math with the
  statistics summed in another order). The means are held: the gap's mean
  within the band's. Point by point the gap leaves the band at steps 1, 2,
  4, 15 and 17 (ROADMAP.md, F1): at the first steps a one-ulp change of one
  element moves the loss less than any change of summation order does, and
  the control leaves it there too (step 1: 1.48% against a band of 0.04%),
  so the point-wise reading is printed, not held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu.parallel.dp import eps_queue
from vae_cyclegan_tpu.utils import torch_import
from vae_cyclegan_tpu_torch import parity_curves
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.utils.jax_import import params_from_jax

pytestmark = pytest.mark.slow

ARCH = "vaegan"
IMAGE, BASE, LATENT, BATCH, STEPS, SEED = 32, 8, 8, 2, 40, 0
PROBES = 5
#: tests/torch_families.py's one-step tolerances: metrics (relative, with
#: 1e-5 absolute), spectral vectors, and one Adam quantum on the parameters
METRIC_RTOL, SPECTRAL_ATOL, LR = 1e-3, 1e-6, 2e-4
#: the bisect's bars on the other loss terms and on the update
TERM_RTOL, PARAM_LRS, MOVED_SHARE = 1e-2, 10, 0.05


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def probe_index(i: int) -> int:
    return 7 * i + 1


def jax_bump_one_element(params, which: int):
    """JAX's counterpart of ``parity_curves.bump_one_element``: one element
    of weight leaf `which` (ndim > 1, modulo their count) one ulp up."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    weights = [i for i, leaf in enumerate(leaves) if leaf.ndim > 1]
    k = weights[which % len(weights)]
    flat = np.asarray(leaves[k]).reshape(-1).copy()
    j = which % flat.size
    flat[j] = np.nextafter(flat[j], np.float32(np.inf))
    leaves[k] = jnp.asarray(flat.reshape(leaves[k].shape))
    return jax.tree_util.tree_unflatten(tree, leaves)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_curves():
    """(the JAX initial weights as a port state_dict, JAX's run: its
    G_loss curve, its per-step metrics and the state before each step and
    after the last, and its PROBES probes' curves)."""
    jtask = jax_create_task(ARCH, model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE), paired=True)
    state = jax.jit(jtask.init_state)(jax.random.PRNGKey(SEED))
    params = params_from_jax(np_tree(state.params), np_tree(state.spectral))
    batches, eps = parity_curves.trajectory_inputs(STEPS, IMAGE, BATCH, SEED,
                                                   LATENT, 2)

    def run(st, b, e):
        with eps_queue(list(e)):
            return jtask.train_step(st, b)

    step = jax.jit(run)

    def curve(st, record=None):
        out = []
        for (x, y), e in zip(batches, eps):
            if record is not None:
                record["states"].append(st)
            st, m = step(st, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                         [jnp.asarray(a) for a in e])
            assert float(m["nan_detected"]) == 0.0
            out.append(float(m["G_loss"]))
            if record is not None:
                record["metrics"].append({k: float(v) for k, v in m.items()})
        if record is not None:
            record["states"].append(st)
        return out

    run_ = {"states": [], "metrics": []}
    run_["G_loss"] = curve(state, run_)
    probes = [curve(state.replace(params=jax_bump_one_element(
        state.params, probe_index(i)))) for i in range(PROBES)]
    return params, run_, probes


@pytest.fixture(scope="module")
def jax_run():
    return jax_curves()


def port_curve(params, probe=None, instance_norm="auto"):
    got = parity_curves.run_trajectory(
        ARCH, STEPS, IMAGE, BATCH, SEED, "cpu", torch.float32, instance_norm,
        params, base_width=BASE, latent_dim=LATENT, probe=probe)
    assert got["nan_detected"] == [0.0] * STEPS
    return got["G_loss"]


def own_band(base, probes):
    gaps = [parity_curves.step_gaps(p, base) for p in probes]
    return [max(g[t] for g in gaps) for t in range(STEPS)]


def load_jax_state(task, state) -> None:
    """The port's task at a JAX state: parameters and spectral vectors
    (``params_from_jax``), and each Adam's moments and count."""
    task.load_state_dict(params_from_jax(np_tree(state.params),
                                         np_tree(state.spectral)))
    names = {id(p): n for n, p in task.nets.named_parameters()}
    for group, opt, params in (("G", task.opt_g, task.gen_params),
                               ("D", task.opt_d, task.disc_params)):
        adam = state.opt_state[group][0]
        if int(adam.count) == 0:
            continue
        mu, nu = (params_from_jax(np_tree({**state.params, group: tree}),
                                  np_tree(state.spectral))
                  for tree in (adam.mu, adam.nu))
        for p in params:
            opt.state[p] = {"step": torch.tensor(float(adam.count)),
                            "exp_avg": mu[names[id(p)]].clone(),
                            "exp_avg_sq": nu[names[id(p)]].clone()}


def test_vaegan_every_step_matches_jax_from_jax_state(jax_run):
    """The bisect: no step of the 40 is at fault."""
    _, run, _ = jax_run
    batches, eps = parity_curves.trajectory_inputs(STEPS, IMAGE, BATCH, SEED,
                                                   LATENT, 2)
    task = create_task(ARCH, model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    worst = {"loss": 0.0, "term": 0.0, "spectral": 0.0, "param": 0.0,
             "moved": 0.0}
    for t, ((x, y), e) in enumerate(zip(batches, eps)):
        load_jax_state(task, run["states"][t])
        got = {k: float(v) for k, v in task.train_step(
            {"x": x, "y": y}, eps=e).items()}
        want = run["metrics"][t]
        assert set(got) == set(want)
        for key in want:
            rel = abs(got[key] - want[key]) / max(abs(want[key]), 1e-9)
            kind = "loss" if key in ("G_loss", "D_loss") else "term"
            assert rel <= (METRIC_RTOL if kind == "loss" else TERM_RTOL) or \
                abs(got[key] - want[key]) <= 1e-5, (t, key, rel)
            worst[kind] = max(worst[kind], rel)
        params, spectral = torch_import.import_reference_state_dict(
            ARCH, {k: v.numpy() for k, v in task.state_dict().items()})
        after = run["states"][t + 1]
        worst["spectral"] = max(worst["spectral"], max(
            float(np.abs(a - b).max()) for a, b in zip(
                jax.tree_util.tree_leaves(spectral),
                jax.tree_util.tree_leaves(np_tree(after.spectral)))))
        moved = n = 0
        for a, b in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(np_tree(after.params))):
            d = np.abs(a - b)
            worst["param"] = max(worst["param"], float(d.max()))
            moved, n = moved + int((d > LR).sum()), n + d.size
        worst["moved"] = max(worst["moved"], moved / n)
    print(f"{ARCH}: {STEPS} steps from JAX's state, worst relative gaps: "
          f"G_loss/D_loss {worst['loss']:.2e}, other terms "
          f"{worst['term']:.2e}; spectral {worst['spectral']:.2e}; "
          f"parameters {worst['param']:.2e} (lr {LR:g}), share beyond lr "
          f"{worst['moved']:.4%}")
    assert worst["spectral"] <= SPECTRAL_ATOL
    assert worst["param"] <= PARAM_LRS * LR
    assert worst["moved"] <= MOVED_SHARE


def test_vaegan_gap_to_jax_against_the_chaos_band(jax_run):
    params, run, jax_probes = jax_run
    want = run["G_loss"]
    got = port_curve(params)
    port_probes = [port_curve(params, probe_index(i)) for i in range(PROBES)]
    control = port_curve(params, instance_norm="tiled")
    for curve in (want, got, control, *jax_probes, *port_probes):
        assert len(curve) == STEPS and np.isfinite(curve).all()
    band_jax, band_port = own_band(want, jax_probes), own_band(got,
                                                               port_probes)
    band = [max(a, b) for a, b in zip(band_jax, band_port)]
    gap = parity_curves.step_gaps(got, want)
    ctrl = parity_curves.step_gaps(control, got)
    over = [t for t in range(1, STEPS) if gap[t] > band[t]]
    ctrl_over = [t for t in range(1, STEPS) if ctrl[t] > band[t]]
    print(f"{ARCH} {STEPS} steps, {PROBES} one-ulp probes a side")
    for t in range(STEPS):
        print(f"  step {t:2d}: port-JAX gap {gap[t]:.4%}, band {band[t]:.4%} "
              f"(JAX {band_jax[t]:.4%}, port {band_port[t]:.4%}), control "
              f"{ctrl[t]:.4%}" + (" OVER" if t in over else ""))
    mean_gap, mean_band = float(np.mean(gap[1:])), float(np.mean(band[1:]))
    print(f"  mean over steps 1-{STEPS - 1}: gap {mean_gap:.4%}, band "
          f"{mean_band:.4%}, control {float(np.mean(ctrl[1:])):.4%}; steps "
          f"over the band: port-JAX {over}, control {ctrl_over}; "
          f"trajectory-mean gap {parity_curves.mean_gap(got, want):.4%}")
    assert gap[0] <= METRIC_RTOL
    assert mean_gap <= mean_band
