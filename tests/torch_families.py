"""Shared by the port's family tests (tests/test_torch_families_*.py and
tests/test_torch_tiled.py): one architecture's task run on both sides from
the same state, and the kernel sites of its full-width training step.

Small size for the numbers: image 32, base_width 8, latent_dim 8, batch 2,
paired unless a test asks for unpaired, f32 on the CPU, where the JAX task
runs its plain XLA lowering (or, for the tiled configuration, its TPU
dispatch with the kernels in interpret mode) and the port its kernels'
plain versions. Inputs and noise are made
with numpy and handed to both sides (``eps_queue`` on the JAX side, ``eps=``
in the port); weights go into the port through ``params_from_jax``.

The tolerances are tests/test_torch_train.py's for cyclevaegan: forward
quantities (metrics, images) tight, the spectral vectors and the
discriminator's gradient tight, and the generator's parameters to the Adam
quantum (2 lr after one step), because the generator step's f32 gradient is
chaotic at random weights (ROADMAP.md, queue 3). What a wrong gradient
would still show there is the share of elements that Adam moved the other
way (the sign of the first step is the sign of the gradient): that share is
bounded as well.
"""

import importlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu.ops.reflect_conv import reflect_conv as jax_reflect_conv
from vae_cyclegan_tpu.parallel.dp import eps_queue
from vae_cyclegan_tpu.utils import torch_import
from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.config import ModelConfig, instance_norm_mode
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.models.tasks.base import Task
from vae_cyclegan_tpu_torch.utils.jax_import import params_from_jax

IMAGE, BASE, LATENT, BATCH = 32, 8, 8, 2
LR = 2e-4
# images: InstanceNorm over the 2x2 planes of a 32-px image divides by tiny
# variances, so single elements stray past tests/test_reference_parity.py's
# band (atol 1e-3, rtol 1e-2): measured at most 1.5e-3 with outputs up to
# 10.7, and at most 9.6e-5 relative L2, over the ten tasks. Bounds: 1e-3 of
# the largest output per element, 1e-3 relative L2.
IMAGE_MAX_SHARE, IMAGE_REL_L2 = 1e-3, 1e-3
METRIC_RTOL = 1e-3
# the tasks whose step threads a discriminator's spectral state
GAN = {"aegan": ("D",), "vaegan": ("D",), "cycleaegan": ("DX", "DY"),
       "cyclevaegan": ("DX", "DY")}

jin = importlib.import_module("vae_cyclegan_tpu.ops.instance_norm")
jsc = importlib.import_module("vae_cyclegan_tpu.ops.starved_conv")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items() if k not in ("Gx", "Fy")}


def _inputs(task):
    """(batch, train_step's eps, eval_step's eps), NHWC numpy."""
    rng = np.random.RandomState(0)
    batch = {k: rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
             for k in ("x", "y")}
    shape = (BATCH, IMAGE // 16, IMAGE // 16, LATENT)
    train = [rng.randn(*shape).astype(np.float32) for _ in task.train_passes]
    evaluate = [rng.randn(*shape).astype(np.float32)
                for _ in task.eval_passes]
    return batch, train, evaluate


def xla_starved_convs(monkeypatch):
    """Keep the JAX package's starved-conv dispatch (the sites, the
    channel-major handover at U4) but compute the conv kernels' calls with
    their XLA equivalents, which its own tests hold the kernels to:
    interpret mode for them costs about a minute of tracing per step."""

    def conv_cm(x_cm, w, *, pad_mode):
        k = w.shape[0]
        x = jnp.transpose(x_cm, (0, 1, 3, 2))
        if pad_mode == "reflect":
            y = jax_reflect_conv(x, w)
        else:
            p = k // 2 if pad_mode == "zero_same" else k - 1
            y = jax.lax.conv_general_dilated(
                x, w.astype(x.dtype), (1, 1), [(p, p), (p, p)],
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.transpose(y, (0, 1, 3, 2))

    def dw(x_cm, g_cm, *, k):
        x = jnp.transpose(x_cm, (0, 1, 3, 2)).astype(jnp.float32)
        g = jnp.transpose(g_cm, (0, 1, 3, 2)).astype(jnp.float32)
        w0 = jnp.zeros((k, k, x.shape[-1], g.shape[-1]), jnp.float32)
        return jax.vjp(lambda w: jax_reflect_conv(x, w), w0)[1](g)[0]

    monkeypatch.setattr(jsc, "_conv_dispatch_cm", conv_cm)
    monkeypatch.setattr(jsc, "_dw_call", dw)


def run_pair(name, use_pallas=None, paired=True, remat=False):
    """The JAX task and the port's from the JAX task's initial state: the
    bridge's round trip of that state, generate and eval_step on it, then
    one train_step (metrics, params and spectral trees, the port's carried
    back through the JAX package's torch importer, and the discriminators'
    Adam first moments). `paired` and `remat` go to both tasks."""
    jtask = jax_create_task(name, model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE,
        use_pallas=use_pallas, remat=remat), paired=paired)
    state = jax.jit(jtask.init_state)(jax.random.PRNGKey(0))
    init = (np_tree(state.params), np_tree(state.spectral))
    ttask = create_task(name, model=ModelConfig(
        IMAGE, LATENT, BASE, instance_norm=instance_norm_mode(use_pallas),
        remat=remat), paired=paired, device="cpu")
    ttask.load_state_dict(params_from_jax(*init), strict=True)
    out = {"init": init, "bridge": torch_import.import_reference_state_dict(
        name, {k: v.numpy().copy() for k, v in ttask.state_dict().items()})}
    batch, train_eps, eval_eps = _inputs(ttask)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)

    def with_eps(fn):
        def run(st, b, e):
            with eps_queue(list(e)):
                return fn(st, b)
        return jax.jit(run)

    def jeps(eps):
        return [jnp.asarray(e) for e in eps]

    gen_eps = eval_eps[:1] if ttask.train_passes else []
    out["generate"] = (
        np.asarray(with_eps(lambda st, b: jtask.generate(st, b, key))(
            state, jb, jeps(gen_eps))),
        ttask.generate(batch, eps=gen_eps[0] if gen_eps else None).numpy())
    jev = with_eps(lambda st, b: jtask.eval_step(st, b, key))(
        state, jb, jeps(eval_eps))
    tev = ttask.eval_step(batch, eps=eval_eps)
    out["eval"] = (_floats(jev), _floats(tev),
                   {k: (np.asarray(jev[k]), tev[k].numpy())
                    for k in ("Gx", "Fy") if k in jev or k in tev})

    state1, jm = with_eps(jtask.train_step)(state, jb, jeps(train_eps))
    tm = ttask.train_step(batch, eps=train_eps)
    # copies: the optimizer updates the live tensors in place
    sd = {k: v.numpy().copy() for k, v in ttask.state_dict().items()}
    back = torch_import.import_reference_state_dict(name, sd)
    out["jax"] = (_floats(jm), np_tree(state1.params),
                  np_tree(state1.spectral))
    out["port"] = (_floats(tm), *back)
    if name in GAN:
        names = {id(p): n for n, p in ttask.nets.named_parameters()}
        moments = {names[id(p)]: ttask.opt_d.state[p]["exp_avg"].numpy().copy()
                   for p in ttask.disc_params}
        tmu = torch_import.import_reference_state_dict(
            name, {**sd, **moments})[0]
        jmu = np_tree(state1.opt_state["D"][0].mu)
        keys = GAN[name]
        out["d_moments"] = (jmu if keys == ("D",) else
                            {k: jmu[k] for k in keys},
                            tmu["D"] if keys == ("D",) else
                            {k: tmu[k] for k in keys})
    return out


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def check_bridge(out):
    """params_from_jax loaded strictly, and the port's state_dict carried
    back by the JAX package's importer, bit for bit."""
    for got, want in zip(out["bridge"], out["init"]):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(_leaves(got), _leaves(want)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _check_image(got, want):
    assert got.shape == want.shape == (BATCH, IMAGE, IMAGE, 3)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= IMAGE_MAX_SHARE * np.abs(want).max()
    assert np.linalg.norm(got - want) <= IMAGE_REL_L2 * np.linalg.norm(want)


def check_generate(out):
    want, got = out["generate"]
    _check_image(got, want)


def check_eval(out):
    """The same metric keys, each within rtol 1e-3 (measured at most 4.4e-4,
    vaegan's), and the images as generate's."""
    jm, tm, images = out["eval"]
    assert set(tm) == set(jm)
    for key in jm:
        assert abs(tm[key] - jm[key]) <= METRIC_RTOL * abs(jm[key]) + 1e-5, key
    assert images
    for want, got in images.values():
        _check_image(got, want)


def check_train_step(out, name, flipped_share):
    """One train_step from the same state: the same metric keys, each
    within rtol 1e-3 (forward quantities, before any update); spectral u/v
    within 1e-6 and the discriminator's gradient (Adam's first moment)
    within 1e-3 relative L2 per tensor (1e-5 absolute for the biases ahead
    of an InstanceNorm, whose gradient is rounding noise); every parameter
    within one Adam quantum, 2 lr, of JAX's; and at most `flipped_share` of
    the elements moved the other way (further apart than lr). Returns the
    measured share."""
    jm, jp, js = out["jax"]
    tm, tp, ts = out["port"]
    assert set(tm) == set(jm) and "nan_detected" in tm
    for key in jm:
        assert abs(tm[key] - jm[key]) <= METRIC_RTOL * abs(jm[key]) + 1e-5, key
    assert tm["nan_detected"] == jm["nan_detected"] == 0.0
    if name in GAN:
        assert max(float(np.abs(a - b).max()) for a, b in
                   zip(_leaves(ts), _leaves(js))) <= 1e-6
        jmu, tmu = out["d_moments"]
        for a, b in zip(_leaves(jmu), _leaves(tmu)):
            assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(a) + 1e-5
    worst, flipped, n = 0.0, 0, 0
    for a, b in zip(_leaves(tp), _leaves(jp)):
        d = np.abs(a - b)
        worst = max(worst, float(d.max()))
        flipped += int((d > LR).sum())
        n += d.size
    assert worst <= 2 * LR + 1e-6
    assert flipped / n <= flipped_share, flipped / n
    return flipped / n


# ---------------------------------------------------------------------------
# kernel sites of a full-width training step
# ---------------------------------------------------------------------------


def head_dx(batch_size):
    """The encoder head's dx site, which the JAX trace computes (and drops)
    where the head's input is data, and the port does not."""
    return ("starved_conv_dx", (batch_size, 64, 256, 256), "bfloat16", 7, 64,
            3, None, None)


def jax_kernel_sites(monkeypatch, jtask, batch_size, fn="train_step",
                     image=256):
    """The JAX package's Pallas launcher calls for one `fn` (train_step or
    generate) of `jtask` on `image`-px batches, traced with jax.eval_shape
    and the TPU dispatch forced on (interpret mode, so the kernels could also
    run here), as NCHW-shaped site tuples in the port's vocabulary. The
    tiled kernel counts where it runs, not where ``_tile_rows`` sends it
    back to ``_fused_reference``."""
    monkeypatch.setattr(jin, "_on_tpu", lambda: True)
    monkeypatch.setattr(jin, "_INTERPRET", True)
    monkeypatch.setattr(jsc, "_INTERPRET", True)
    for knob in ("VCT_STARVED_FORCE", "VCT_STARVED_CONV", "VCT_STARVED_DX",
                 "VCT_STARVED_DW", "VCT_STARVED_FWD"):
        monkeypatch.delenv(knob, raising=False)
    # the abstract state first: Flax's init runs forwards of its own
    state = jax.eval_shape(jtask.init_state, jax.random.PRNGKey(0))
    sites = []
    in_act, tiled = jin._pallas_in_act, jin._pallas_in_act_tiled
    conv_call, dw_call = jsc._conv_call, jsc._dw_call

    def record_in_act(x, act, order, eps, interpret=False):
        n, h, w, c = x.shape
        sites.append(("in_act", (n, c, h, w), str(x.dtype), None, None, None,
                      act, order))
        return in_act(x, act, order, eps, interpret=interpret)

    def record_tiled(x, act, order, eps, interpret=False):
        n, h, w, c = x.shape
        if (h * w) % jin._tile_rows(h * w, c) == 0:
            sites.append(("in_act_tiled", (n, c, h, w), str(x.dtype), None,
                          None, None, act, order))
        return tiled(x, act, order, eps, interpret=interpret)

    def record_conv(x, w_packed, *, k, p, cin, cout, reflect):
        n, h, c, w = x.shape  # channel-major
        assert p == k // 2  # reflect forward or zero_same dx, never full
        kind = "starved_conv" if reflect else "starved_conv_dx"
        sites.append((kind, (n, c, h, w), str(x.dtype), k, cin, cout, None,
                      None))
        return conv_call(x, w_packed, k=k, p=p, cin=cin, cout=cout,
                         reflect=reflect)

    def record_dw(x, g, *, k):
        n, h, c, w = x.shape
        sites.append(("starved_conv_dw", (n, c, h, w), str(x.dtype), k, c,
                      g.shape[2], None, None))
        return dw_call(x, g, k=k)

    monkeypatch.setattr(jin, "_pallas_in_act", record_in_act)
    monkeypatch.setattr(jin, "_pallas_in_act_tiled", record_tiled)
    monkeypatch.setattr(jsc, "_conv_call", record_conv)
    monkeypatch.setattr(jsc, "_dw_call", record_dw)
    images = jax.ShapeDtypeStruct((batch_size, image, image, 3), jnp.float32)
    batch = {"x": images, "y": images}
    if fn == "train_step":
        jax.eval_shape(jtask.train_step, state, batch)
    else:
        jax.eval_shape(lambda st, b: jtask.generate(st, b,
                                                    jax.random.PRNGKey(1)),
                       state, batch)
    return sites


def port_train_sites(monkeypatch, name, batch_size, instance_norm="auto",
                     fn="train_step", paired=True):
    """The port's kernel sites for one `fn` of the full-width bf16 task on
    the meta device."""
    task = create_task(name, model=ModelConfig(
        256, 64, 64, torch.bfloat16, instance_norm=instance_norm),
        paired=paired, device="meta")
    # no values on the meta device: the finiteness check passes the step
    monkeypatch.setattr(Task, "_finite_update",
                        staticmethod(lambda opt, loss, params, grads: 0.0))
    image = torch.empty(batch_size, 256, 256, 3, device="meta")
    with kernels.record_sites() as sites:
        getattr(task, fn)({"x": image, "y": image})
    return sites


def check_full_width_sites(monkeypatch, name, counts, data_fed, b=4,
                           use_pallas=None):
    """The port's training sites against the JAX TPU trace: the same
    multiset but for the head dx of the `data_fed` passes whose head input
    is data, the same forward sites in the same order, and `counts` per
    kind."""
    jtask = jax_create_task(name, model=JModelConfig(
        image_size=256, latent_dim=64, base_width=64, dtype=jnp.bfloat16,
        use_pallas=use_pallas), paired=True)
    jax_sites = jax_kernel_sites(monkeypatch, jtask, b)
    sites = port_train_sites(monkeypatch, name, b,
                             instance_norm_mode(use_pallas))
    assert Counter(s[0] for s in sites) == counts
    assert Counter(jax_sites) - Counter(sites) == Counter(
        {head_dx(b): data_fed})
    assert not Counter(sites) - Counter(jax_sites)
    forward = ("in_act", "in_act_tiled", "starved_conv")
    assert [s for s in sites if s[0] in forward] == \
        [s for s in jax_sites if s[0] in forward]
