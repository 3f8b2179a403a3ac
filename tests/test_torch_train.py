"""The port's training slice against the JAX package: losses, spectral norm,
the discriminator, the weight bridge with the discriminators, the
cyclevaegan train_step / eval_step, the finite-loss guard, and the kernel
sites of the full-width training step.

Small size for the numbers: image 32, base_width 8, latent_dim 8, batch 2,
paired, f32 on the CPU, where the JAX task runs its plain XLA lowering and
the port its kernels' plain versions. Inputs and noise are made with numpy
and handed to both sides (``eps_queue`` on the JAX side, ``eps=`` in the
port); the JAX step is compiled once per module. The full-width site check
traces shapes only: the port on the ``meta`` device, JAX under
``jax.eval_shape`` with its TPU dispatch forced on.

On tolerances: the generator step's gradient is chaotic in f32 at random
weights. The JAX package's own f32 and f64 gradients of one step differ by
4-60% per parameter tensor (at 32, 64 and 128 px: a logvar at its clip of
10 amplifies a rounding by exp(5), and InstanceNorm over 2x2 planes divides
by tiny variances), so the port can hold the generator's parameters only to
what Adam makes of any gradient: one step moves an element by at most lr,
and the port's and JAX's steps can differ by twice that where a gradient is
rounding noise. The forward quantities (metrics, spectral vectors) and the
discriminator's well-conditioned gradient are held tightly.
"""

import math
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_families import jax_kernel_sites
from vae_cyclegan_tpu import losses as jlosses
from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models import networks as jnets
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu.ops.spectral_norm import (
    spectral_normalize as jax_spectral_normalize,
)
from vae_cyclegan_tpu.parallel.dp import eps_queue
from vae_cyclegan_tpu.utils import torch_import
from vae_cyclegan_tpu_torch import kernels, losses
from vae_cyclegan_tpu_torch.config import LossConfig, ModelConfig
from vae_cyclegan_tpu_torch.models.networks import Discriminator
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.models.tasks.base import Task
from vae_cyclegan_tpu_torch.models.tasks.cyclegan import GEN_PASSES
from vae_cyclegan_tpu_torch.ops.spectral_norm import spectral_normalize
from vae_cyclegan_tpu_torch.utils.jax_import import (
    discriminator_from_jax,
    params_from_jax,
)

IMAGE, BASE, LATENT, BATCH = 32, 8, 8, 2
LR, BETAS = 2e-4, (0.5, 0.999)
STEPS = 3
# tests/test_tasks.py's reference metric keys of cyclevaegan's train_step
TRAIN_KEYS = {
    "total_loss", "G_loss", "D_loss",
    "D_loss_x_real", "D_loss_x_fake", "D_loss_y_real", "D_loss_y_fake",
    "loss_cycle", "loss_gan_g",
    "loss_gan_g_x_real", "loss_gan_g_x_fake",
    "loss_gan_g_y_real", "loss_gan_g_y_fake",
    "loss_kl", "d_x_real_mean", "d_x_fake_mean",
    "d_y_real_mean", "d_y_fake_mean", "loss_identity",
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _adam_bound(t: int) -> float:
    """The largest |m_hat| / sqrt(v_hat) Adam can reach at step t, whatever
    the gradients: sqrt(sum_i a_i^2 / c_i) with a_i, c_i the bias-corrected
    weights of gradient i in m_hat and v_hat (1, 1.054, 1.134 for t = 1, 2,
    3 at betas 0.5/0.999). An element's step is at most lr times this."""
    b1, b2 = BETAS
    total = 0.0
    for i in range(1, t + 1):
        a = (1 - b1) * b1 ** (t - i) / (1 - b1 ** t)
        c = (1 - b2) * b2 ** (t - i) / (1 - b2 ** t)
        total += a * a / c
    return math.sqrt(total)


# ---------------------------------------------------------------------------
# the tiny task, stepped on both sides from the same state
# ---------------------------------------------------------------------------


def _inputs():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        x = rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
        y = rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
        eps = [rng.randn(BATCH, IMAGE // 16, IMAGE // 16, LATENT)
               .astype(np.float32) for _ in GEN_PASSES]
        out.append(({"x": x, "y": y}, eps))
    return out


@pytest.fixture(scope="module")
def runs():
    """Both sides from the JAX task's initial state: after each of three
    train_steps, the metrics, the params and spectral trees (the port's
    carried back through the JAX package's torch importer) and, after the
    first, the D optimizer's first moments; then eval_step's metrics."""
    jtask = jax_create_task("cyclevaegan", model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE,
        use_pallas=False), paired=True)
    state = jax.jit(jtask.init_state)(jax.random.PRNGKey(0))
    init = (_np_tree(state.params), _np_tree(state.spectral))

    def step(st, batch, eps):
        with eps_queue(list(eps)):
            return jtask.train_step(st, batch)

    def evaluate(st, batch, eps):
        with eps_queue(list(eps)):
            return jtask.eval_step(st, batch, jax.random.PRNGKey(1))

    jstep, jeval = jax.jit(step), jax.jit(evaluate)
    ttask = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT, BASE),
                        device="cpu")
    ttask.load_state_dict(params_from_jax(*init), strict=True)
    out = {"init": init, "jax": [], "port": []}
    for i, (batch, eps) in enumerate(_inputs()):
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          [jnp.asarray(e) for e in eps])
        tm = ttask.train_step(batch, eps=eps)
        # copies: the optimizer updates the live tensors in place
        sd = {k: v.numpy().copy() for k, v in ttask.state_dict().items()}
        back = torch_import.import_reference_state_dict("cyclevaegan", sd)
        out["jax"].append(({k: float(v) for k, v in jm.items()},
                           _np_tree(state.params), _np_tree(state.spectral)))
        out["port"].append(({k: float(v) for k, v in tm.items()}, *back))
        if i == 0:
            names = {id(p): n for n, p in ttask.nets.named_parameters()}
            moments = {names[id(p)]:
                       ttask.opt_d.state[p]["exp_avg"].numpy().copy()
                       for p in ttask.disc_params}
            out["d_moments"] = (
                _np_tree(state.opt_state["D"][0].mu),
                torch_import.import_reference_state_dict(
                    "cyclevaegan", {**sd, **moments})[0])
    batch, eps = _inputs()[0]
    out["eval"] = (
        jeval(state, {k: jnp.asarray(v) for k, v in batch.items()},
              [jnp.asarray(e) for e in eps]),
        ttask.eval_step(batch, eps=eps))
    out["jax64"] = _jax64_metrics(init)
    return out


def _jax64_metrics(init):
    """The JAX task over the same three steps in float64 from the same (f32)
    state: its metrics at each step, its parameters after the first, and
    its eval_step's metrics; the reference for how far rounding alone moves
    an f32 trajectory."""
    with jax.enable_x64(True):
        jtask = jax_create_task("cyclevaegan", model=JModelConfig(
            image_size=IMAGE, latent_dim=LATENT, base_width=BASE,
            use_pallas=False, dtype=jnp.float64), paired=True)
        state = jax.jit(jtask.init_state)(jax.random.PRNGKey(0))
        f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        state = state.replace(params=jax.tree_util.tree_map(f64, init[0]),
                              spectral=jax.tree_util.tree_map(f64, init[1]))
        state = state.replace(opt_state={
            "G": jtask.tx_g.init({k: state.params[k] for k in ("G", "F")}),
            "D": jtask.tx_d.init({k: state.params[k] for k in ("DX", "DY")})})

        def step(st, batch, eps):
            with eps_queue(list(eps)):
                return jtask.train_step(st, batch)

        def evaluate(st, batch, eps):
            with eps_queue(list(eps)):
                return jtask.eval_step(st, batch, jax.random.PRNGKey(1))

        jstep, metrics = jax.jit(step), []
        for i, (batch, eps) in enumerate(_inputs()):
            state, m = jstep(state, {k: f64(v) for k, v in batch.items()},
                             [f64(e) for e in eps])
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                params = jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float32), state.params)
        batch, eps = _inputs()[0]
        m = jax.jit(evaluate)(state, {k: f64(v) for k, v in batch.items()},
                              [f64(e) for e in eps])
        ev = {k: float(v) for k, v in m.items() if k not in ("Gx", "Fy")}
    return {"metrics": metrics, "params": params, "eval": ev}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _param_gaps(got, want):
    """Largest element gap, and the share of elements further apart than
    rounding (1e-6), over all parameters."""
    worst, beyond, n = 0.0, 0, 0
    for (_, a), b in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
        d = np.abs(a - b)
        worst = max(worst, float(d.max()))
        beyond += int((d > 1e-6).sum())
        n += d.size
    return worst, beyond / n


def _spectral_gap(got, want):
    return max(float(np.abs(a - b).max()) for a, b in
               zip(jax.tree_util.tree_leaves(got),
                   jax.tree_util.tree_leaves(want)))


def test_one_train_step_matches_jax(runs):
    """Step 1 from the same state. Metrics (forward quantities, before any
    update) within rtol 1e-3: measured at most 2.8e-4 relative (loss_kl,
    where exp(logvar) at the clip amplifies a 1e-4 difference in logvar).
    Spectral u/v within 1e-6 (measured 1.5e-8). The discriminator step's
    gradient, read from Adam's first moment, within 1e-3 relative L2 per
    tensor (or 1e-5 absolute, for the biases ahead of an InstanceNorm whose
    gradient is rounding noise); measured at most 4.8e-5. Every parameter
    within one Adam quantum, 2 lr, of JAX's (measured 2.000 lr); against
    JAX's float64 step, the port moves 5.8% of the elements to another
    side than rounding allows, JAX's own f32 step 7.3%: at most twice that
    (+1%) is allowed."""
    jm, jp, js = runs["jax"][0]
    tm, tp, ts = runs["port"][0]
    assert set(tm) == set(jm) == TRAIN_KEYS | {"nan_detected"}
    for key in jm:
        assert abs(tm[key] - jm[key]) <= 1e-3 * abs(jm[key]) + 1e-5, key
    assert tm["nan_detected"] == jm["nan_detected"] == 0.0
    assert _spectral_gap(ts, js) <= 1e-6
    jmu, tmu = runs["d_moments"]
    for (path, a), b in zip(_leaves(jmu), jax.tree_util.tree_leaves(
            {"DX": tmu["DX"], "DY": tmu["DY"]})):
        gap = np.linalg.norm(a - b)
        assert gap <= 1e-3 * np.linalg.norm(a) + 1e-5, path
    worst, _ = _param_gaps(tp, jp)
    assert worst <= 2 * LR * _adam_bound(1) + 1e-6
    # where a gradient is rounding noise its Adam sign is a coin toss: the
    # port flips no more of them against JAX's float64 step than JAX's own
    # float32 step does
    share = _param_gaps(tp, runs["jax64"]["params"])[1]
    share_jax = _param_gaps(jp, runs["jax64"]["params"])[1]
    assert share <= 2 * share_jax + 0.01


def _metric_gap(got, want):
    """Mean over the metrics of |got - want| / (|want| + 0.01)."""
    return float(np.mean([abs(got[k] - want[k]) / (abs(want[k]) + 1e-2)
                          for k in want]))


def test_three_train_steps_and_eval_match_jax(runs):
    """Three steps, each from the previous one's state on both sides. The
    f32 trajectories leave each other as fast as rounding lets a chaotic
    step (JAX's own f32 and f64 runs differ by 0.6% in G_loss and 4.7% in
    D_loss at step 2, and by up to 2.6x in a GAN term at step 3), so the
    port is held to the float64 trajectory of the JAX package about as
    closely as JAX's own f32 trajectory is: its mean relative metric gap
    (``_metric_gap``) to the f64 run, summed over steps 2 and 3 and
    eval_step, at most 4 times JAX f32's (measured 0.768 against 0.329,
    2.33 times; one seed of a chaotic trajectory, so the sum and not each
    step). Spectral u/v within 1e-4 of
    JAX f32's (measured 3.2e-5); parameters within twice Adam's largest
    three-step travel, 2 lr (1 + 1.054 + 1.134) = 6.38 lr (measured 6.37
    lr: an element whose gradient is rounding noise took opposite signs at
    every step)."""
    travel = 2 * LR * sum(_adam_bound(t) for t in range(1, STEPS + 1))
    port_gap = jax_gap = 0.0
    for i in range(1, STEPS):
        jm, jp, js = runs["jax"][i]
        tm, tp, ts = runs["port"][i]
        ref = runs["jax64"]["metrics"][i]
        port_gap += _metric_gap(tm, ref)
        jax_gap += _metric_gap(jm, ref)
        assert _spectral_gap(ts, js) <= 1e-4
        assert tm["nan_detected"] == 0.0
    worst, _ = _param_gaps(tp, jp)
    assert worst <= travel + 1e-6
    jev, tev = runs["eval"]
    assert set(tev) == set(jev)
    for key in ("Gx", "Fy"):
        got = tev[key].float().numpy()
        assert got.shape == jev[key].shape == (BATCH, IMAGE, IMAGE, 3)
        assert np.isfinite(got).all()
    ref = runs["jax64"]["eval"]
    port_gap += _metric_gap({k: float(tev[k]) for k in ref}, ref)
    jax_gap += _metric_gap({k: float(jev[k]) for k in ref}, ref)
    assert port_gap <= 4 * jax_gap


def test_nan_guard_skips_the_whole_update():
    """A non-finite loss skips optimizer.step() whole: parameters, Adam's
    moments and its step count stay as they were, nan_detected is 1."""
    task = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    task.init(0)
    (batch, eps), _, _ = _inputs()
    assert task.train_step(batch, eps=eps)["nan_detected"] == 0.0
    params = {k: v.clone() for k, v in task.state_dict().items()
              if not k.endswith(("weight_u", "weight_v"))}
    adam = [{k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in opt.state[p].items()}
            for opt, group in ((task.opt_g, task.gen_params),
                               (task.opt_d, task.disc_params))
            for p in group]
    bad = {"x": np.full_like(batch["x"], np.nan), "y": batch["y"]}
    metrics = task.train_step(bad, eps=eps)
    assert float(metrics["nan_detected"]) == 1.0
    assert not np.isfinite(float(metrics["G_loss"]))
    for k, v in params.items():
        torch.testing.assert_close(task.state_dict()[k], v, rtol=0, atol=0)
    after = [opt.state[p] for opt, group in ((task.opt_g, task.gen_params),
                                             (task.opt_d, task.disc_params))
             for p in group]
    for old, new in zip(adam, after):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(new[key], old[key], rtol=0, atol=0)
    assert all(p.grad is None for p in task.gen_params + task.disc_params)


def test_metric_keys_follow_paired_and_the_loss_weights():
    """Unpaired, the identity loss leaves the metrics and G_loss; G_loss is
    lambda_cycle*cycle + lambda_gan*(fake terms) + lambda_kl*KL
    [+ lambda_identity*identity]."""
    (batch, eps), _, _ = _inputs()
    for paired in (True, False):
        task = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT,
                                                            BASE),
                           loss=LossConfig(lambda_kl=2e-5), paired=paired,
                           device="cpu")
        task.init(0)
        m = task.eval_step(batch, eps=eps)
        keys = TRAIN_KEYS - {"d_x_real_mean", "d_x_fake_mean",
                             "d_y_real_mean", "d_y_fake_mean"}
        want_keys = keys | {"Gx", "Fy"}
        if not paired:
            want_keys -= {"loss_identity"}
        assert set(m) == want_keys
        g = (10.0 * m["loss_cycle"] + m["loss_gan_g_x_fake"]
             + m["loss_gan_g_y_fake"] + 2e-5 * m["loss_kl"])
        if paired:
            g = g + 5.0 * m["loss_identity"]
        torch.testing.assert_close(m["G_loss"], g, rtol=1e-6, atol=0)
        torch.testing.assert_close(m["loss_gan_g"], m["loss_gan_g_x_fake"]
                                   + m["loss_gan_g_y_fake"])


def test_weight_bridge_round_trip_with_discriminators(runs):
    """{G, F, DX, DY} and the spectral vectors go into the port strictly,
    and back through the JAX package's own torch importer bit for bit (v
    permuted from (kH, kW, I) to torch's (I, kH, kW) and back)."""
    params, spectral = runs["init"]
    task = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    task.load_state_dict(params_from_jax(params, spectral), strict=True)
    sd = {k: v.numpy() for k, v in task.state_dict().items()}
    assert sd["DX.model.4.weight_v"].shape == (8 * BASE * 2 * 2,)
    back_p, back_s = torch_import.import_reference_state_dict("cyclevaegan",
                                                              sd)
    for got, want in ((back_p, params), (back_s, spectral)):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="spectral"):
        params_from_jax(params)


# ---------------------------------------------------------------------------
# the discriminator's parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("update", [True, False])
def test_spectral_normalize_matches_jax(update):
    """Three chained calls on a (1, 64, 4, 4) weight from the same u, v
    (v permuted to torch's order): w / sigma and the new u, v within 1e-6
    (measured 7.5e-9)."""
    rng = np.random.RandomState(5)
    w = rng.randn(1, 64, 4, 4).astype(np.float32) * 0.1   # OIHW
    u = rng.randn(1).astype(np.float32)
    v = rng.randn(4, 4, 64).astype(np.float32).reshape(-1)  # (kH, kW, I)
    v /= np.linalg.norm(v)
    wj = jnp.asarray(np.transpose(w, (2, 3, 1, 0)))
    uj, vj = jnp.asarray(u), jnp.asarray(v)
    ut = torch.from_numpy(u)
    vt = torch.from_numpy(np.ascontiguousarray(
        np.transpose(v.reshape(4, 4, 64), (2, 0, 1)).reshape(-1)))
    for _ in range(3):
        wsn_j, uj, vj = jax_spectral_normalize(wj, uj, vj, update)
        wsn_t, ut, vt = spectral_normalize(torch.from_numpy(w), ut, vt,
                                           update)
        np.testing.assert_allclose(
            wsn_t.numpy(), np.transpose(np.asarray(wsn_j), (3, 2, 0, 1)),
            atol=1e-6)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-6)
        np.testing.assert_allclose(
            vt.numpy(), np.transpose(np.asarray(vj).reshape(4, 4, 64),
                                     (2, 0, 1)).reshape(-1), atol=1e-6)


@pytest.mark.parametrize("update", [True, False])
def test_discriminator_matches_jax(update):
    """The discriminator at 32 px (final kernel 2) on bridged weights and
    u, v: its scores, its spectral state after the call, and the gradients
    of a cotangent-weighted sum with respect to its input and every
    parameter, f32 (measured max errors 3.3e-6, 0, 8.5e-6, and 2.1e-6
    relative L2 per parameter tensor; 1.6e-5 absolute for the biases ahead
    of an InstanceNorm)."""
    jdisc = jnets.Discriminator(final_kernel=2, base_width=BASE,
                                init_nonlinearity="relu")
    rng = np.random.RandomState(6)
    x = rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    cot = rng.randn(BATCH).astype(np.float32)
    variables = _np_tree(jdisc.init(jax.random.PRNGKey(3), x))
    tdisc = Discriminator(final_kernel=2, base_width=BASE)
    tdisc.load_state_dict(discriminator_from_jax(variables["params"],
                                                 variables["spectral"]),
                          strict=True)

    def jf(p, xx):
        out = jdisc.apply({"params": p, "spectral": variables["spectral"]},
                          xx, update_stats=update,
                          mutable=["spectral"] if update else False)
        scores, spec = out if update else (out, {"spectral":
                                                 variables["spectral"]})
        return jnp.sum(scores * cot), (scores, spec["spectral"])

    (_, (scores, spec)), (gp, gx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    got = tdisc(xt, update_stats=update)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(scores),
                               atol=1e-5)
    sd = {k: v.numpy() for k, v in tdisc.state_dict().items()}
    _, back_s = torch_import.discriminator_params(sd)
    assert _spectral_gap(back_s, _np_tree(spec)) <= 1e-6
    np.testing.assert_allclose(
        np.transpose(xt.grad.numpy(), (0, 2, 3, 1)), np.asarray(gx),
        atol=1e-5)
    grads = {n: p.grad.numpy() for n, p in tdisc.named_parameters()}
    back_g, _ = torch_import.discriminator_params({**sd, **grads})
    for (path, a), b in zip(_leaves(_np_tree(gp)),
                            jax.tree_util.tree_leaves(back_g)):
        # + 2e-5: the biases ahead of an InstanceNorm, whose gradient is
        # rounding noise (norms ~1e-5)
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(a) + 2e-5, path


LOSSES = {
    "translation_loss": 2, "cycle_consistency_loss": 4, "identity_loss": 4,
    "gan_loss_generator": 2, "gan_loss_discriminator": 2, "kl_divergence": 2,
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    """Each loss on the same random tensors (logvar spread past the +-10
    clip), f32 scalars within rtol 1e-6 (measured at most 3.1e-7)."""
    rng = np.random.RandomState(len(name))
    args = [(rng.randn(BATCH, 4, 4, 3) * 6).astype(np.float32)
            for _ in range(LOSSES[name])]
    want = getattr(jlosses, name)(*map(jnp.asarray, args))
    got = getattr(losses, name)(*[torch.from_numpy(a) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.dim() == 0
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# ---------------------------------------------------------------------------
# kernel sites of the full-width training step
# ---------------------------------------------------------------------------


def test_full_width_training_sites_match_jax_tpu_path(monkeypatch):
    """256x256, base 64, latent 64, bf16, batch 4: the port's train_step
    (meta device) and the JAX TPU path's (eval_shape) pick the same kernel
    sites with the same shapes, k, channels, activations and orders, but
    for the input gradient of the encoder head where the head's input is
    data (G(x), G(y), F(y), F(x)): the JAX trace computes it and leaves it
    unused, the port does not compute it. Per step: 46 IN+act (6 generator
    passes x 5, 8 discriminator passes x 2), 12 reflect convs (U4 and tail
    of each pass), 14 zero_same dx convs (U4 and tail of each pass, the
    head of F(Gx) and G(Fy)) and 18 dw (head, U4, tail of each pass)."""
    b = 4
    jtask = jax_create_task("cyclevaegan", model=JModelConfig(
        image_size=256, latent_dim=64, base_width=64, dtype=jnp.bfloat16),
        paired=True)
    jax_sites = jax_kernel_sites(monkeypatch, jtask, b)

    task = create_task("cyclevaegan", model=ModelConfig(
        256, 64, 64, torch.bfloat16), device="meta")
    # no values on the meta device: the finiteness check passes the step
    monkeypatch.setattr(Task, "_finite_update",
                        staticmethod(lambda opt, loss, params, grads: 0.0))
    image = torch.empty(b, 256, 256, 3, device="meta")
    with kernels.record_sites() as sites:
        task.train_step({"x": image, "y": image})
    counts = Counter(s[0] for s in sites)
    assert counts == {"in_act": 46, "starved_conv": 12,
                      "starved_conv_dx": 14, "starved_conv_dw": 18}
    head_dx = ("starved_conv_dx", (b, 64, 256, 256), "bfloat16", 7, 64, 3,
               None, None)
    assert Counter(jax_sites) - Counter(sites) == Counter({head_dx: 4})
    assert not Counter(sites) - Counter(jax_sites)
    # the forward sites, in the reference's call order
    forward = [s for s in sites if s[0] in ("in_act", "starved_conv")]
    assert forward == [s for s in jax_sites
                       if s[0] in ("in_act", "starved_conv")]
