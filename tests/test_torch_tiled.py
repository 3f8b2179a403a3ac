"""The tiled InstanceNorm configuration against the JAX package's
``use_pallas="tiled"``: the plain version of the two-pass kernel (K2) and
its gradient against ``_pallas_in_act_tiled`` and ``_fused_tpu_tiled`` in
interpret mode, the dispatch and its fallback, the cyclevaegan step and
generate under the configuration, and the kernel sites of the full-width
step and forward.

The port's kernel runs only on a GPU (tests/test_torch_kernels.py); here
its wrapper must take the plain version, which is what these tests hold
against JAX. Small sizes as tests/torch_families.py.
"""

import dataclasses
import importlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_families import (
    check_eval,
    check_full_width_sites,
    check_generate,
    check_train_step,
    jax_kernel_sites,
    port_train_sites,
    run_pair,
    xla_starved_convs,
)
from vae_cyclegan_tpu.config import ModelConfig as JModelConfig
from vae_cyclegan_tpu.models.tasks import create_task as jax_create_task
from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.config import ModelConfig, instance_norm_mode
from vae_cyclegan_tpu_torch.models.networks import Decoder

jin = importlib.import_module("vae_cyclegan_tpu.ops.instance_norm")
jsc = importlib.import_module("vae_cyclegan_tpu.ops.starved_conv")
tin = importlib.import_module("vae_cyclegan_tpu_torch.ops.instance_norm")

ACTS = ["relu", "leaky_relu", "tanh", "sigmoid", "identity"]
ORDERS = ["norm_act", "act_norm"]
# a budget that cuts a (16, 16, 32) slab into four tiles of 64 rows, and a
# 9x9 plane into tiles of 20 rows, which do not divide 81
BUDGET = 8 * 1024


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test. The plain version's
    activation, ``torch.tanh`` on 16384 elements, is cut into chunks of 2048
    (or 4096) run on the intra-op threads, and on a loaded machine (the
    suite's six workers, or six runs of this file at once) one worker's
    chunk of one call, mostly the process's first, came out up to 5.1e-5
    from float64 while every other intermediate matched the other call's:
    the bitwise checks here failed a few times in some thirty runs of this
    file. On one thread no chunk leaves the calling thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_tiles(monkeypatch):
    monkeypatch.setattr(jin, "_VMEM_SLAB_BYTES", BUDGET)
    monkeypatch.setattr(tin, "SLAB_BYTES", BUDGET)


def _to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _to_nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _bf16_band(want):
    """One bf16 rounding of each element, plus one at the largest magnitude
    for sums whose terms were rounded in another order."""
    return 2.0 ** -7 * (np.abs(want) + np.abs(want).max())


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("act", ACTS)
def test_tiled_reference_matches_jax_tiled_kernel(small_tiles, one_thread,
                                                  act, order, dtype):
    """tiled_reference (and the dispatch under "tiled", which takes it on
    the CPU) against _pallas_in_act_tiled in interpret mode over four HW
    tiles. f32: atol 1e-5; bf16, same bf16 input: the kernel and the port
    round once at the same place, so they agree to within one rounding of
    each element plus the f32 tolerance (the last bit of tanh or sigmoid
    may differ between torch and XLA)."""
    assert tin.tile_rows(256, 32) == jin._tile_rows(256, 32) == 64
    x = np.random.RandomState(0).randn(2, 16, 16, 32).astype(np.float32)
    x = x * 2.0 + 0.5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = _to_nchw(x).to(tdt)
    got = _to_nhwc(tin.tiled_reference(xt, act, order))
    with kernels.record_sites() as sites:
        dispatched = tin.instance_norm_act(xt, act=act, order=order,
                                           mode="tiled")
    np.testing.assert_array_equal(_to_nhwc(dispatched), got)
    assert sites == [("in_act_tiled", (2, 32, 16, 16), dtype, None, None,
                      None, act, order)]
    want = np.asarray(jin._pallas_in_act_tiled(
        jnp.asarray(x, jdt), act, order, 1e-5, interpret=True), np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-5).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ORDERS)
def test_tiled_fallback_matches_jax_when_tiles_do_not_divide(
        small_tiles, one_thread, order, dtype):
    """A 9x9 plane under the small budget: JAX's tile of 20 rows does not
    divide 81, so its kernel falls back to _fused_reference; the port's
    dispatch does the same and records no kernel site. Exact in f32 but for
    summation order (atol 1e-5), one rounding in bf16."""
    assert jin._tile_rows(81, 64) == tin.tile_rows(81, 64) == 20
    assert not tin.tiles_fit((1, 64, 9, 9))
    x = np.random.RandomState(1).randn(1, 9, 9, 64).astype(np.float32) + 0.3
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    with kernels.record_sites() as sites:
        got = _to_nhwc(tin.instance_norm_act(_to_nchw(x).to(tdt), act="tanh",
                                             order=order, mode="tiled"))
    assert sites == []
    want = np.asarray(jin._pallas_in_act_tiled(
        jnp.asarray(x, jdt), "tanh", order, 1e-5, interpret=True), np.float32)
    ref = _to_nhwc(tin.fused_reference(_to_nchw(x).to(tdt), "tanh", order))
    np.testing.assert_array_equal(got, ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert (np.abs(got - want) <= _bf16_band(want)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("act", ACTS)
def test_tiled_gradient_matches_jax_vjp(small_tiles, one_thread, act, order,
                                        dtype):
    """_InActTiled's (y, dx) against jax.vjp of _fused_tpu_tiled with the
    JAX kernels in interpret mode (the flag restored afterwards): the
    forward is the single-pass kernel, the backward _fused_tpu_bwd with
    centered statistics on both sides. f32: rtol and atol 1e-5; bf16: one
    rounding (``_bf16_band``)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 16, 32).astype(np.float32) + 0.3
    g = rng.randn(2, 16, 16, 32).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = _to_nchw(x).to(tdt).requires_grad_()
    y = tin.instance_norm_act(xt, act=act, order=order, mode="tiled")
    (dx,) = torch.autograd.grad(y, xt, _to_nchw(g).to(tdt))
    assert y.dtype == dx.dtype == tdt
    jin.set_interpret(True)
    try:
        jy, vjp = jax.vjp(lambda v: jin._fused_tpu_tiled(v, act, order, 1e-5),
                          jnp.asarray(x, jdt))
        (jdx,) = vjp(jnp.asarray(g, jdt))
    finally:
        jin.set_interpret(False)
    for got, want in ((_to_nhwc(y), jy), (_to_nhwc(dx), jdx)):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert (np.abs(got - want) <= _bf16_band(want)).all()


def test_tiled_dispatch_on_cpu_takes_plain_version():
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 80, 64, 64)
                         .astype(np.float32))
    assert not tin.slab_fits(x.shape)
    y = tin.instance_norm_act(x, act="relu", order="act_norm", mode="tiled")
    assert tin.in_act_tiled_cuda.launches == 0
    torch.testing.assert_close(y, tin.tiled_reference(x, "relu", "act_norm"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tin.in_act_tiled_cuda(x, "relu", "act_norm")
    with pytest.raises(ValueError, match="mode"):
        tin.instance_norm_act(x, mode="fast")


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------


def test_instance_norm_mode_maps_jax_use_pallas():
    assert instance_norm_mode(None) == instance_norm_mode(True) == "auto"
    assert instance_norm_mode("tiled") == "tiled"
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        instance_norm_mode(False)
    with pytest.raises(ValueError):
        instance_norm_mode("fast")
    with pytest.raises(ValueError, match="instance_norm"):
        ModelConfig(instance_norm="plain")
    tiled = ModelConfig(instance_norm="tiled")
    assert dataclasses.replace(tiled, instance_norm="auto") == ModelConfig()


@pytest.mark.parametrize("image,base,dtype,want", [
    (256, 64, torch.bfloat16, "plain"), (32, 8, torch.float32, "plain"),
    (256, 64, torch.float16, "tiled"), (256, 128, torch.bfloat16, "tiled")])
def test_u4_norm_follows_jax_channel_major_rule(monkeypatch, image, base,
                                                dtype, want):
    """Under "tiled" the Decoder's U4 IN stays plain exactly where JAX's
    cm_engaged holds for both U4's and the tail's conv (its TPU dispatch
    forced on); under "auto" the site keeps its mode."""
    monkeypatch.setattr(jsc, "_INTERPRET", True)
    monkeypatch.delenv("VCT_STARVED_CONV", raising=False)
    w, s = base, image // 2
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
           torch.float16: jnp.float16}[dtype]
    cm = (jsc.cm_engaged((4, 2 * s, 2 * s, w // 2), (3, 3, w // 2, w), jdt)
          and jsc.cm_engaged((4, 2 * s, 2 * s, w), (7, 7, w, 3), jdt))
    assert cm == (want == "plain")
    x = torch.empty(4, 2 * w, s, s, device="meta")
    for mode, expect in (("tiled", want), ("auto", "auto")):
        dec = Decoder(base, dtype=dtype, device="meta", instance_norm=mode)
        assert dec._u4_norm(x) == expect


# ---------------------------------------------------------------------------
# the cyclevaegan task under "tiled", against JAX's use_pallas="tiled"
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiled_pair():
    """run_pair under the TPU dispatch: the tiled kernel in interpret mode,
    the starved-conv sites and the U4 channel-major handover as on the TPU
    (their kernels computed by XLA, xla_starved_convs)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jin, "_INTERPRET", True)
        mp.setattr(jsc, "_INTERPRET", True)
        for knob in ("VCT_STARVED_FORCE", "VCT_STARVED_CONV",
                     "VCT_STARVED_DX", "VCT_STARVED_DW", "VCT_STARVED_FWD"):
            mp.delenv(knob, raising=False)
        xla_starved_convs(mp)
        return run_pair("cyclevaegan", use_pallas="tiled")


def test_tiled_generate_matches_jax(tiled_pair):
    check_generate(tiled_pair)


def test_tiled_eval_step_matches_jax(tiled_pair):
    check_eval(tiled_pair)


def test_tiled_train_step_matches_jax(tiled_pair):
    """Tolerances of tests/torch_families.py (metrics measured within
    2.6e-4 relative); the share of parameter elements on the other Adam
    sign than JAX's, measured 0.0289, is held to 0.06."""
    check_train_step(tiled_pair, "cyclevaegan", 0.06)


# ---------------------------------------------------------------------------
# kernel sites at full width
# ---------------------------------------------------------------------------


def test_full_width_tiled_training_sites_match_jax_tpu_path(monkeypatch):
    """256x256, base 64, latent 64, bf16, batch 4, "tiled": per step 96
    tiled IN (12 sites in each of 6 generator passes, 3 in each of 8
    discriminator passes), no one-pass IN, and the auto step's 12 reflect
    convs, 14 zero_same dx and 18 dw; the same sites as the JAX TPU trace
    but for the 4 data-fed head dx."""
    check_full_width_sites(monkeypatch, "cyclevaegan", {
        "in_act_tiled": 96, "starved_conv": 12, "starved_conv_dx": 14,
        "starved_conv_dw": 18}, 4, use_pallas="tiled")


def test_full_width_tiled_forward_sites_match_jax_tpu_path(monkeypatch):
    """generate under "tiled": 12 of the generator's 13 IN sites take the
    tiled kernel (U4's stays plain, the channel-major handover), then U4's
    and the tail's conv; the sites and their order equal the JAX trace."""
    b = 4
    jtask = jax_create_task("cyclevaegan", model=JModelConfig(
        image_size=256, latent_dim=64, base_width=64, dtype=jnp.bfloat16,
        use_pallas="tiled"))
    jax_sites = jax_kernel_sites(monkeypatch, jtask, b, fn="generate")
    sites = port_train_sites(monkeypatch, "cyclevaegan", b, "tiled",
                             fn="generate")
    assert sites == jax_sites
    assert Counter(s[0] for s in sites) == {"in_act_tiled": 12,
                                            "starved_conv": 2}
    shapes = [s[1][1:] for s in sites if s[0] == "in_act_tiled"]
    assert shapes == [(64, 256, 256), (128, 128, 128), (256, 64, 64),
                      (512, 32, 32), (1024, 16, 16), (1024, 16, 16),
                      (1024, 16, 16), (1024, 16, 16), (1024, 16, 16),
                      (512, 32, 32), (256, 64, 64), (128, 128, 128)]
