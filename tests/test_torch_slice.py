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

from torch_families import jax_kernel_sites
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
    """(JAX task, its G/F params, the port's task loaded from them and the
    discriminators' params and spectral vectors)."""
    jtask = jax_create_task("cyclevaegan", model=JModelConfig(
        image_size=IMAGE, latent_dim=LATENT, base_width=BASE))
    x = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
    params, spectral = {}, {}
    for name, seed in (("G", 0), ("F", 1), ("DX", 2), ("DY", 3)):
        key = jax.random.PRNGKey(seed)
        tree = jax.tree_util.tree_map(np.asarray, getattr(jtask, name).init(
            {"params": key, "reparam": key}, x))
        params[name] = tree["params"]
        if "spectral" in tree:
            spectral[name] = tree["spectral"]
    ttask = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT, BASE),
                        device="cpu")
    ttask.load_state_dict(params_from_jax(params, spectral), strict=True)
    gen = {name: params[name] for name in ("G", "F")}
    return jtask, gen, ttask


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
    jtask, _, ttask = pair
    x = np.zeros((BATCH, IMAGE, IMAGE, 3), np.float32)
    jax_sites = jax_kernel_sites(monkeypatch, jtask, BATCH, fn="generate",
                                 image=IMAGE)
    with kernels.record_sites() as sites:
        ttask.generate({"x": torch.from_numpy(x)})
    u4, tail = jax_sites[-2:]
    assert u4[0] == tail[0] == "starved_conv" and (u4[3], tail[3]) == (3, 7)
    u4_in = ("in_act", (BATCH, BASE, IMAGE, IMAGE), "float32", None, None,
             None, "relu", "act_norm")
    assert sites == jax_sites[:-1] + [u4_in, tail]


def test_init_is_seeded_and_matches_reference_init():
    task = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    task.init(3)
    again = create_task("cyclevaegan", model=ModelConfig(IMAGE, LATENT, BASE),
                        device="cpu")
    again.init(3)
    for (name, a), b in zip(task.state_dict().items(),
                            again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        if name.endswith(".bias"):
            assert not a.any()
        elif name.endswith((".weight_u", ".weight_v")):  # unit normal
            assert abs(float(a.norm()) - 1.0) < 1e-5, name
        else:  # Kaiming normal, fan_out, relu gain
            cout, _, kh, kw = a.shape
            std = float(a.std())
            assert 0.5 < std / np.sqrt(2.0 / (cout * kh * kw)) < 1.5, name
    # G and F, 18 convs each; DX and DY, 4 convs and the spectral conv's
    # bias, weight_orig, weight_u, weight_v each
    assert len(task.state_dict()) == 2 * 36 + 2 * 12
    # the generators' draws come first: adding the discriminators did not
    # change them
    gen_only = torch.Generator().manual_seed(3)
    first = task.G.encoder.model[0].conv.weight
    torch.testing.assert_close(
        first, torch.randn(first.shape, generator=gen_only)
        * np.sqrt(2.0 / (first.shape[0] * 49)), rtol=0, atol=0)


def test_configs_default_to_the_jax_package_values():
    """Field for field, the JAX configs' defaults, with torch dtypes; JAX's
    use_pallas maps to instance_norm, its remat is remat."""
    jcfg = importlib.import_module("vae_cyclegan_tpu.config")
    tcfg = importlib.import_module("vae_cyclegan_tpu_torch.config")
    for name in ("ModelConfig", "OptimConfig", "LossConfig"):
        want = dataclasses.asdict(getattr(jcfg, name)())
        got = dataclasses.asdict(getattr(tcfg, name)())
        if name == "ModelConfig":
            assert got.pop("instance_norm") == tcfg.instance_norm_mode(
                want.pop("use_pallas")) == "auto"
            assert got.pop("remat") is want.pop("remat") is False
            assert want.pop("dtype") == jnp.float32
            assert got.pop("dtype") == torch.float32
        assert got == want, name


def test_create_task_names():
    """All ten architectures construct on the CPU when asked for it, with
    the JAX package's names, has_fy and discriminators."""
    jtasks = importlib.import_module("vae_cyclegan_tpu.models.tasks")
    assert list(ARCHITECTURES) == list(jtasks.ARCHITECTURES)
    with pytest.raises(ValueError):
        create_task("pix2pix", device="cpu")
    for name in ARCHITECTURES:
        task = create_task(name, model=ModelConfig(32, 8, 8), device="cpu")
        assert task.name == name and task.device == torch.device("cpu")
        assert task.has_fy == jtasks.ARCHITECTURES[name].has_fy
        assert all(p.device.type == "cpu" for p in task.nets.parameters())


@pytest.mark.parametrize("name", ["vae", "cyclevaegan"])
def test_tasks_default_to_the_card(name):
    """Without a device the task goes to CUDA; on a machine without one the
    constructor raises and never hands back a CPU task."""
    if torch.cuda.is_available():
        assert create_task(name, model=ModelConfig(32, 8, 8)).device.type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_task(name, model=ModelConfig(32, 8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ARCHITECTURES[name](model=ModelConfig(32, 8, 8))


# ---------------------------------------------------------------------------
# kernel sites of the full-width serving forward
# ---------------------------------------------------------------------------


def test_full_width_kernel_sites_match_jax_tpu_path(monkeypatch):
    """256x256, base 64, latent 64, bf16, batch 4: the port (meta device)
    and the JAX TPU path (eval_shape) pick the same 5 IN+act and 2 conv
    kernel sites, with the same shapes, k, cin, cout, activation and order."""
    b = 4
    jtask = jax_create_task("cyclevaegan", model=JModelConfig(
        image_size=256, latent_dim=64, base_width=64, dtype=jnp.bfloat16))
    jax_sites = jax_kernel_sites(monkeypatch, jtask, b, fn="generate")

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
