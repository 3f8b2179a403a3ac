"""The port's serving slice against the JAX package: the cyclevaegan task's
``generate`` and ``run_inference`` on the same weights and noise, and the
kernel sites of the full-width generator forward.

Small size for the numbers: image 64, base_width 16 (the smallest width at
which U4's cin of 8 reaches the conv kernel's forward rule), latent_dim 8,
batch 2, f32 on the CPU, where the JAX task runs its plain XLA lowering.
The full-width site check traces shapes only: the port on the ``meta``
device, JAX under ``jax.eval_shape`` with its TPU dispatch forced on.
"""

import dataclasses
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu.parallel.dp import eps_queue
from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.inference import run_inference
from vae_cyclegan_tpu_torch.models.tasks import ARCHITECTURES, create_task
from vae_cyclegan_tpu_torch.utils.jax_import import params_from_jax

IMAGE, BASE, LATENT, BATCH = 64, 16, 8, 2
ATOL, RTOL = 1e-3, 1e-2  # tests/test_reference_parity.py's band


@pytest.fixture(scope="module")
def pair():
    """(JAX task, its G/F params, the port's task loaded from them)."""
    jtask = jax_create_task("cyclevaegan", model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE))
    x = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
    params = {}
    for name, seed in (("G", 0), ("F", 1)):
        key = jax.random.PRNGKey(seed)
        tree = getattr(jtask, name).init({"params": key, "reparam": key}, x)
        params[name] = jax.tree_util.tree_map(np.asarray, tree["params"])
    ttask = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT, BASE))
    ttask.load_state_dict(params_from_jax(params), strict=True)
    return jtask, params, ttask


def _jax_generate(jtask, params, x, eps):
    state = SimpleNamespace(params=params)
    with eps_queue([jnp.asarray(eps)]):
        out = jtask.generate(state, {"x": jnp.asarray(x)},
                             jax.random.PRNGKey(0))
    return np.asarray(out)


def test_generate_matches_jax(pair):
    """Same weights, same eps: measured max error 9.6e-4 (outputs up to
    15.7)."""
    jtask, params, ttask = pair
    rng = np.random.RandomState(0)
    x = rng.rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    eps = rng.randn(BATCH, IMAGE // 16, IMAGE // 16, LATENT).astype(np.float32)
    want = _jax_generate(jtask, params, x, eps)
    got = ttask.generate({"x": torch.from_numpy(x)},
                         eps=torch.from_numpy(eps))
    assert tuple(got.shape) == want.shape == (BATCH, IMAGE, IMAGE, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_run_inference_matches_clipped_jax(pair):
    """run_inference draws eps from a CPU generator seeded with `seed`; the
    same draw, handed to JAX, gives the same clipped images (measured max
    error 5.6e-4)."""
    jtask, params, ttask = pair
    seed = 5
    x = np.random.RandomState(1).rand(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    eps = torch.randn((BATCH, LATENT, IMAGE // 16, IMAGE // 16),
                      generator=torch.Generator().manual_seed(seed))
    want = np.clip(_jax_generate(jtask, params, x,
                                 eps.permute(0, 2, 3, 1).numpy()), 0.0, 1.0)
    got = run_inference(ttask, {"x": x}, seed=seed)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (BATCH, IMAGE, IMAGE, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got, run_inference(ttask, {"x": x},
                                                     seed=seed))


def test_small_slice_takes_the_same_kernel_sites_as_jax(pair, monkeypatch):
    """At the test size too, the port's dispatch picks the kernels where the
    JAX package's TPU dispatch would, with one difference: JAX hands the
    U4 -> IN -> tail chain over channel-major when both convs take its
    kernel, and its channel-major IN always runs on XLA. The port has no
    such handover, so the slab rule alone decides that IN: here its 256 KB
    slab takes the kernel. At full width the slab is 16 MB and both sides
    run the plain version (next test)."""
    jtask, params, ttask = pair
    x = np.zeros((BATCH, IMAGE, IMAGE, 3), np.float32)
    jax_sites = _jax_sites(monkeypatch, jtask, x.shape, params)
    with kernels.record_sites() as sites:
        ttask.generate({"x": torch.from_numpy(x)})
    u4, tail = jax_sites[-2:]
    assert u4[0] == tail[0] == "starved_conv" and (u4[3], tail[3]) == (3, 7)
    u4_in = ("in_act", (BATCH, BASE, IMAGE, IMAGE), "float32", None, None,
             None, "relu", "act_norm")
    assert sites == jax_sites[:-1] + [u4_in, tail]


def test_init_is_seeded_and_matches_reference_init():
    task = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT, BASE))
    task.init(3)
    again = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT, BASE))
    again.init(3)
    for (name, a), b in zip(task.state_dict().items(),
                            again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        if name.endswith(".bias"):
            assert not a.any()
        else:  # Kaiming normal, fan_out, relu gain
            cout, _, kh, kw = a.shape
            std = float(a.std())
            assert 0.5 < std / np.sqrt(2.0 / (cout * kh * kw)) < 1.5, name
    assert len(task.state_dict()) == 2 * 36   # G and F, 18 convs each


def test_configs_default_to_the_jax_package_values():
    """Field for field, the JAX configs' defaults, with torch dtypes; JAX's
    use_pallas and remat have no counterpart."""
    jcfg = importlib.import_module("vae_cyclegan_tpu.config")
    tcfg = importlib.import_module("vae_cyclegan_tpu_torch.config")
    for name in ("ModelConfig", "OptimConfig", "LossConfig"):
        want = dataclasses.asdict(getattr(jcfg, name)())
        got = dataclasses.asdict(getattr(tcfg, name)())
        if name == "ModelConfig":
            assert want.pop("use_pallas") is None and not want.pop("remat")
            assert want.pop("dtype") == jnp.float32
            assert got.pop("dtype") == torch.float32
        assert got == want, name


def test_create_task_names():
    assert len(ARCHITECTURES) == 10
    with pytest.raises(ValueError):
        create_task("pix2pix")
    for name in ARCHITECTURES:
        if name == "cyclevaegan":
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            create_task(name)


# ---------------------------------------------------------------------------
# kernel sites of the full-width serving forward
# ---------------------------------------------------------------------------


def _jax_sites(monkeypatch, jtask, x_shape, params=None):
    """The JAX package's Pallas launcher calls for one `generate`, traced
    with jax.eval_shape and the TPU dispatch forced on (interpret mode, so
    the kernels could also run here), as NCHW-shaped site tuples."""
    jin = importlib.import_module("vae_cyclegan_tpu.ops.instance_norm")
    jsc = importlib.import_module("vae_cyclegan_tpu.ops.starved_conv")
    monkeypatch.setattr(jin, "_on_tpu", lambda: True)
    monkeypatch.setattr(jin, "_INTERPRET", True)
    monkeypatch.setattr(jsc, "_INTERPRET", True)
    monkeypatch.delenv("VCT_STARVED_FORCE", raising=False)
    monkeypatch.delenv("VCT_STARVED_CONV", raising=False)
    key = jax.random.PRNGKey(0)
    if params is None:
        x1 = jax.ShapeDtypeStruct((1,) + tuple(x_shape[1:]), jnp.float32)
        params = {"G": jax.eval_shape(
            lambda x: jtask.G.init({"params": key, "reparam": key}, x),
            x1)["params"]}
    sites = []
    in_act, conv_call = jin._pallas_in_act, jsc._conv_call

    def record_in_act(x, act, order, eps, interpret=False):
        n, h, w, c = x.shape
        sites.append(("in_act", (n, c, h, w), str(x.dtype), None, None, None,
                      act, order))
        return in_act(x, act, order, eps, interpret=interpret)

    def record_conv(x, w_packed, *, k, p, cin, cout, reflect):
        n, h, c, w = x.shape  # channel-major
        assert reflect and p == k // 2
        sites.append(("starved_conv", (n, c, h, w), str(x.dtype), k, cin,
                      cout, None, None))
        return conv_call(x, w_packed, k=k, p=p, cin=cin, cout=cout,
                         reflect=reflect)

    monkeypatch.setattr(jin, "_pallas_in_act", record_in_act)
    monkeypatch.setattr(jsc, "_conv_call", record_conv)
    jax.eval_shape(
        lambda p, x: jtask.generate(SimpleNamespace(params=p), {"x": x}, key),
        params, jax.ShapeDtypeStruct(tuple(x_shape), jnp.float32))
    return sites


def test_full_width_kernel_sites_match_jax_tpu_path(monkeypatch):
    """256x256, base 64, latent 64, bf16, batch 4: the port (meta device)
    and the JAX TPU path (eval_shape) pick the same 5 IN+act and 2 conv
    kernel sites, with the same shapes, k, cin, cout, activation and order."""
    b = 4
    jtask = jax_create_task("cyclevaegan", model=JModelConfig(
        image_size=256, latent_dim=64, base_width=64, dtype=jnp.bfloat16))
    jax_sites = _jax_sites(monkeypatch, jtask, (b, 256, 256, 3))

    task = create_task("cyclevaegan", model=ModelConfig(
        256, 64, 64, torch.bfloat16), device="meta")
    assert sum(p.numel() for p in task.G.parameters()) == 66_216_387
    with kernels.record_sites() as sites:
        out = task.generate({"x": torch.empty(b, 256, 256, 3, device="meta")})
    assert tuple(out.shape) == (b, 256, 256, 3) and out.dtype == torch.bfloat16

    in_act = [("in_act", (b, 1024, 16, 16), "bfloat16", None, None, None,
               act, "act_norm")
              for act in ("relu", "relu", "identity", "relu", "identity")]
    conv = [("starved_conv", (b, 32, 256, 256), "bfloat16", 3, 32, 64, None,
             None),
            ("starved_conv", (b, 64, 256, 256), "bfloat16", 7, 64, 3, None,
             None)]
    assert sites == in_act + conv
    assert jax_sites == sites
