"""The port's ops (vae_cyclegan_tpu_torch.ops) against the JAX package.

Inputs are made with numpy from a seed and go through both sides; the JAX
side's Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them. The port's kernels run only on a GPU
(tests/test_torch_kernels.py); here its wrappers must take the plain
version, which is what these tests hold against JAX.
"""

import importlib
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_cyclegan_tpu.ops.reflect_conv import _naive_reflect_conv
from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.ops.reflect_conv import reflect_conv

# the modules themselves (each package re-exports a function that shadows
# its `instance_norm` submodule)
jin = importlib.import_module("vae_cyclegan_tpu.ops.instance_norm")
jsc = importlib.import_module("vae_cyclegan_tpu.ops.starved_conv")
tin = importlib.import_module("vae_cyclegan_tpu_torch.ops.instance_norm")
tsc = importlib.import_module("vae_cyclegan_tpu_torch.ops.starved_conv")

ACTS = ["relu", "leaky_relu", "tanh", "sigmoid", "identity"]
ORDERS = ["norm_act", "act_norm"]
# tests/test_starved_conv.py CONV_CASES: (h, w, cin, cout, k)
CONV_CASES = [
    (32, 40, 3, 16, 7),
    (32, 40, 16, 3, 7),
    (32, 32, 8, 16, 3),
    (32, 32, 16, 8, 3),
    (48, 40, 3, 8, 5),
    (40, 48, 4, 8, 3),
]


def _to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _to_nhwc(t):
    return np.transpose(t.float().numpy(), (0, 2, 3, 1))


def _bf16_ulp(a):
    """One bf16 ulp at the largest magnitude of `a` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


# ---------------------------------------------------------------------------
# IN + activation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("act", ACTS)
def test_in_act_plain_matches_jax_reference_and_pallas(act, order):
    """f32, atol 1e-5 (as tests/test_ops.py holds the Pallas kernel);
    measured max error 4.8e-7 over the ten cases."""
    x = np.random.RandomState(0).randn(2, 4, 4, 16).astype(np.float32) + 0.3
    got = _to_nhwc(tin.fused_reference(_to_nchw(x), act, order))
    ref = np.asarray(jin._fused_reference(jnp.asarray(x), act, order, 1e-5))
    pallas = np.asarray(jin._pallas_in_act(jnp.asarray(x), act, order, 1e-5,
                                           interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_in_act_plain_bf16_matches_jax(act):
    """bf16: relu and identity agree exactly with both JAX versions. For
    the others the activation's last bit may differ between torch and XLA,
    and the Pallas kernel does not round between activation and norm, so
    they may differ by one bf16 ulp at the output's largest magnitude
    (measured: 0 against _fused_reference, exactly 1 ulp against the kernel
    for act_norm tanh/sigmoid)."""
    x = np.random.RandomState(1).randn(2, 8, 8, 16).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = _to_nchw(x).to(torch.bfloat16)
    for order in ORDERS:
        got = _to_nhwc(tin.fused_reference(xt, act, order))
        for want in (jin._fused_reference(xj, act, order, 1e-5),
                     jin._pallas_in_act(xj, act, order, 1e-5,
                                        interpret=True)):
            want = np.asarray(want.astype(jnp.float32))
            if act in ("relu", "identity"):
                np.testing.assert_array_equal(got, want)
            else:
                assert np.abs(got - want).max() <= _bf16_ulp(want), order


def test_instance_norm_act_dispatch_on_cpu_takes_plain_version():
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 64, 16, 16)
                         .astype(np.float32))
    before = tin.in_act_cuda.launches
    with kernels.record_sites() as sites:
        y = tin.instance_norm_act(x, act="relu", order="act_norm")
    assert tin.in_act_cuda.launches == before == 0
    torch.testing.assert_close(y, tin.fused_reference(x, "relu", "act_norm"),
                               rtol=0, atol=0)
    assert sites == [("in_act", (2, 64, 16, 16), "float32", None, None, None,
                      "relu", "act_norm")]
    with pytest.raises(ValueError, match="CUDA"):
        tin.in_act_cuda(x, "relu", "act_norm")


# ---------------------------------------------------------------------------
# starved conv
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_starved_interpret(monkeypatch):
    # as tests/test_starved_conv.py: force the Pallas path for every shape
    # and run it in interpret mode
    monkeypatch.setenv("VCT_STARVED_FORCE", "1")
    monkeypatch.setattr(jsc, "_INTERPRET", True)


@pytest.mark.parametrize("h,w,cin,cout,k", CONV_CASES)
def test_reflect_conv_matches_jax_kernel_and_naive(jax_starved_interpret, h, w,
                                                   cin, cout, k):
    """f32, atol 5e-5 (as tests/test_starved_conv.py); measured max error
    1.1e-5 against both the interpret-mode kernel and the naive conv."""
    rng = np.random.RandomState(h + w + cin + cout + k)
    x = rng.randn(2, h, w, cin).astype(np.float32)
    wgt = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(wgt, (3, 2, 0, 1))))
    got = _to_nhwc(reflect_conv(_to_nchw(x), wt))
    got_dispatch = _to_nhwc(tsc.starved_reflect_conv(_to_nchw(x), wt))
    pallas = np.asarray(jsc._starved_conv(jnp.asarray(x), jnp.asarray(wgt)))
    naive = np.asarray(_naive_reflect_conv(jnp.asarray(x), jnp.asarray(wgt)))
    assert got.shape == pallas.shape == (2, h, w, cout)
    np.testing.assert_array_equal(got_dispatch, got)
    assert np.abs(got - pallas).max() < 5e-5
    assert np.abs(got - naive).max() < 5e-5


def _cm(t):
    """NCHW torch -> channel-major (N, H, C, W) jax array."""
    return jnp.asarray(np.transpose(t.float().numpy(), (0, 2, 1, 3)),
                       jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


def _from_cm(a):
    """channel-major (N, H, C, W) jax array -> NCHW f32 numpy."""
    return np.transpose(np.asarray(a, np.float32), (0, 2, 1, 3))


def _hwio(w):
    """OIHW torch -> HWIO jax array, in w's dtype."""
    return jnp.asarray(np.transpose(w.float().numpy(), (2, 3, 1, 0)),
                       jnp.bfloat16 if w.dtype == torch.bfloat16
                       else jnp.float32)


def _conv_inputs(seed, n, cin, cout, h, w, k):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, cin, h, w).astype(np.float32))
    wgt = torch.from_numpy((rng.randn(cout, cin, k, k) * 0.1)
                           .astype(np.float32))
    g = torch.from_numpy(rng.randn(n, cout, h, w).astype(np.float32))
    return x, wgt, g


@pytest.mark.parametrize("mode", ["zero_same", "zero"])
@pytest.mark.parametrize("h,w,cin,cout,k", CONV_CASES)
def test_zero_conv_plain_matches_jax_kernel(jax_starved_interpret, h, w, cin,
                                            cout, k, mode):
    """The plain zero-padded conv against _conv_call in the same mode
    (interpret mode), f32, atol 5e-5 as tests/test_starved_conv.py; measured
    max error 1.0e-5 over the twelve cases."""
    x, wgt, _ = _conv_inputs(k + cin, 2, cin, cout, h, w, k)
    got = tsc.zero_conv(x, wgt, mode).numpy()
    want = _from_cm(jsc._conv_dispatch_cm(_cm(x), _hwio(wgt), pad_mode=mode))
    grow = k - 1 if mode == "zero" else 0
    assert got.shape == want.shape == (2, cout, h + grow, w + grow)
    assert np.abs(got - want).max() < 5e-5


# shapes that cross the dw kernel's tiles (tests/test_torch_kernels.py
# DW_EDGES): odd h and w with cout 24 and cin*k*k = 125, cout 80, and the
# folded tail's wide M (cin 128)
DW_EDGES = [(35, 45, 5, 24, 5), (38, 72, 16, 80, 3), (34, 40, 128, 3, 7)]


@pytest.mark.parametrize("h,w,cin,cout,k", CONV_CASES + DW_EDGES)
def test_dw_plain_matches_jax_kernel(jax_starved_interpret, h, w, cin, cout,
                                     k):
    """dw_reference against _dw_call (interpret mode): f32 (k, k, cin, cout)
    from both, within 1e-5 of the largest weight gradient (sums of 2*h*w
    products in another order); measured at most 1.0e-6 of it at
    CONV_CASES and 2.1e-6 at DW_EDGES. The plain version is what the card
    kernel is held to, so it is held to JAX's kernel at the card kernel's
    edge shapes too."""
    x, _, g = _conv_inputs(k + cout, 2, cin, cout, h, w, k)
    got = tsc.dw_reference(x, g, k).numpy().transpose(2, 3, 1, 0)
    want = np.asarray(jsc._dw_call(_cm(x), _cm(g), k=k))
    assert got.shape == want.shape == (k, k, cin, cout)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("h,w,cin,cout,k", [
    (32, 40, 8, 3, 7), (40, 32, 16, 8, 3), (48, 48, 3, 8, 5),
    (32, 32, 64, 3, 7), (32, 32, 3, 64, 7)])
def test_dx_border_fold_matches_oracle_and_jax(jax_starved_interpret, h, w,
                                               cin, cout, k):
    """dx of the reflect conv for an incoming gradient g with cin channels
    and the rotated weight (cout out, as tests/test_starved_conv.py): the
    port's fold against its oracle (reflect_fold of the full correlation),
    against the JAX package's oracle (_reflect_fold_cm of _conv_call's zero
    mode) and against JAX's _dx_with_border_fold, f32, atol 5e-5; measured
    max errors 0 (bit for bit), 1.3e-5 and 1.4e-5."""
    rng = np.random.RandomState(h + cin)
    g = torch.from_numpy(rng.randn(2, cin, h, w).astype(np.float32))
    wrot = torch.from_numpy((rng.randn(cout, cin, k, k) * 0.1)
                            .astype(np.float32))
    got = tsc.dx_with_border_fold(g, wrot).numpy()
    oracle = tsc.reflect_fold(tsc.zero_conv(g, wrot, "zero"), k // 2).numpy()
    jax_oracle = _from_cm(jsc._reflect_fold_cm(jsc._conv_dispatch_cm(
        _cm(g), _hwio(wrot), pad_mode="zero"), k // 2))
    want = _from_cm(jsc._dx_with_border_fold(_cm(g), _hwio(wrot), k // 2))
    assert got.shape == oracle.shape == want.shape == (2, cout, h, w)
    assert np.abs(got - oracle).max() < 5e-5
    assert np.abs(got - jax_oracle).max() < 5e-5
    assert np.abs(got - want).max() < 5e-5


def _bf16_band(want):
    """One bf16 rounding of each element, plus one at the largest magnitude
    for sums whose terms were rounded in another order."""
    return 2.0 ** -7 * (np.abs(want) + np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,cin,cout,k", CONV_CASES)
def test_conv_function_gradients_match_jax_vjp(jax_starved_interpret, h, w,
                                               cin, cout, k, dtype):
    """starved_reflect_conv's (y, dx, dw) against jax.vjp of the JAX
    package's _starved_conv (its custom VJP, kernels in interpret mode).
    f32: atol 5e-5 for y and dx, 5e-4 for dw, as tests/test_starved_conv.py
    (measured 1.0e-5, 8.6e-6 and 1.8e-4). bf16, on the same bf16 inputs:
    both round y, dx and dw to bf16 at the same places, so they agree to one
    rounding (``_bf16_band``; measured at most 0.16 of it)."""
    x, wgt, g = _conv_inputs(h + cout, 2, cin, cout, h, w, k)
    tdt = getattr(torch, dtype)
    x, wgt, g = x.to(tdt), wgt.to(tdt), g.to(tdt)
    xa, wa = x.clone().requires_grad_(), wgt.clone().requires_grad_()
    y = tsc.starved_reflect_conv(xa, wa)
    dx, dw = torch.autograd.grad(y, (xa, wa), g)
    assert y.dtype == dx.dtype == dw.dtype == tdt
    nhwc = lambda t: jnp.asarray(  # noqa: E731
        np.transpose(t.float().numpy(), (0, 2, 3, 1)), getattr(jnp, dtype))
    jy, vjp = jax.vjp(jsc._starved_conv, nhwc(x), _hwio(wgt))
    jdx, jdw = vjp(nhwc(g))
    pairs = [(_to_nhwc(y.detach()), jy), (_to_nhwc(dx), jdx),
             (dw.float().numpy().transpose(2, 3, 1, 0), jdw)]
    for i, (got, want) in enumerate(pairs):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        if dtype == "float32":
            assert np.abs(got - want).max() < (5e-4 if i == 2 else 5e-5)
        else:
            assert (np.abs(got - want) <= _bf16_band(want)).all(), i


def test_conv_function_skips_dx_for_data_inputs():
    """dx is computed only where x needs a gradient (the heads fed with
    data); dw always."""
    x, wgt, g = _conv_inputs(0, 2, 3, 16, 32, 32, 7)
    wa = wgt.clone().requires_grad_()
    with kernels.record_sites() as sites:
        y = tsc.starved_reflect_conv(x, wa)
        (dw,) = torch.autograd.grad(y, wa, g)
    assert [s[0] for s in sites] == ["starved_conv_dw"]
    xa = x.clone().requires_grad_()
    with kernels.record_sites() as sites:
        y = tsc.starved_reflect_conv(xa, wa)
        dx, dw2 = torch.autograd.grad(y, (xa, wa), g)
    assert sorted(s[0] for s in sites) == ["starved_conv_dw",
                                           "starved_conv_dx"]
    assert sites[0][1:] == ((2, 16, 32, 32), "float32", 7, 16, 3, None,
                            None) or sites[1][1:] == (
        (2, 16, 32, 32), "float32", 7, 16, 3, None, None)
    torch.testing.assert_close(dw, dw2, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("act", ACTS)
def test_in_act_kernel_site_gradient_matches_jax(act, order, dtype):
    """A kernel site (slab <= 1 MB): instance_norm_act's dx against
    _fused_tpu_bwd on the same x and cotangent. f32: rtol and atol 1e-5
    (measured max error 9.5e-7, 0.05 of the bound); bf16: one rounding (the
    f32 math agrees to ~1e-6 before both round to bf16; measured at most
    1.0e-3 of the band)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 16).astype(np.float32) + 0.3
    g = rng.randn(2, 8, 8, 16).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = _to_nchw(x).to(tdt).requires_grad_()
    y = tin.instance_norm_act(xt, act=act, order=order)
    (dx,) = torch.autograd.grad(y, xt, _to_nchw(g).to(tdt))
    (want,) = jin._fused_tpu_bwd(act, order, 1e-5, jnp.asarray(x, jdt),
                                 jnp.asarray(g, jdt))
    got, want = _to_nhwc(dx), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(got - want) <= _bf16_band(want)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("act", ACTS)
def test_in_act_big_slab_gradient_matches_jax(monkeypatch, act, order, dtype):
    """A slab over 1 MB (plain forward, saved mean and rsqrt): dx against
    _fused_xla_bwd with the residuals of _fused_xla_fwd, whose statistics
    are set to the centered form the port keeps (VCT_IN_TWOPASS=1). f32:
    rtol and atol 1e-5 (sums over 4096 elements; measured max error 1.8e-5,
    0.26 of the bound); bf16: one rounding (measured at most 0.40 of the
    band)."""
    monkeypatch.setenv("VCT_IN_TWOPASS", "1")
    rng = np.random.RandomState(4)
    x = rng.randn(1, 64, 64, 80).astype(np.float32) + 0.3
    g = rng.randn(1, 64, 64, 80).astype(np.float32)
    assert not tin.slab_fits((1, 80, 64, 64))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = _to_nchw(x).to(tdt).requires_grad_()
    y = tin.instance_norm_act(xt, act=act, order=order)
    (dx,) = torch.autograd.grad(y, xt, _to_nchw(g).to(tdt))
    _, res = jin._fused_xla_fwd(jnp.asarray(x, jdt), act, order, 1e-5, (1, 2))
    (want,) = jin._fused_xla_bwd(act, order, 1e-5, (1, 2), res,
                                 jnp.asarray(g, jdt))
    got, want = _to_nhwc(dx), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(got - want) <= _bf16_band(want)).all()


def test_starved_conv_dispatch_on_cpu_takes_plain_version():
    x = torch.randn(2, 32, 64, 64, generator=torch.Generator().manual_seed(0))
    w = torch.randn(64, 32, 3, 3, generator=torch.Generator().manual_seed(1))
    with kernels.record_sites() as sites:
        y = tsc.starved_reflect_conv(x, w)
    assert tsc.reflect_conv_cuda.launches == 0
    torch.testing.assert_close(y, reflect_conv(x, w), rtol=0, atol=0)
    assert sites == [("starved_conv", (2, 32, 64, 64), "float32", 3, 32, 64,
                      None, None)]
    with pytest.raises(ValueError, match="CUDA"):
        tsc.reflect_conv_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        tsc.zero_conv_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        tsc.dw_cuda(x, y, 3)


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------

_DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
           (torch.float16, jnp.float16)]


@pytest.mark.parametrize("tdtype,jdtype", _DTYPES)
def test_conv_rules_match_jax(monkeypatch, tdtype, jdtype):
    """supported / fwd_wins agree with _supported / _fwd_wins over a grid
    that includes the serving path's head, U4 and tail."""
    monkeypatch.delenv("VCT_STARVED_FORCE", raising=False)
    grid = itertools.product((1, 3, 4, 5, 7), (3, 8, 16, 32, 33, 64, 512, 513),
                             (3, 8, 32, 64, 512), (16, 32, 40, 44, 256))
    picked = 0
    for k, cin, cout, hw in grid:
        for h, w in ((hw, hw), (hw, 32), (32, hw)):
            port = tsc.supported((4, cin, h, w), (cout, cin, k, k), tdtype)
            ref = jsc._supported((4, h, w, cin), (k, k, cin, cout), jdtype)
            assert port == ref, (k, cin, cout, h, w)
            assert tsc.fwd_wins(k, cin, cout) == jsc._fwd_wins(k, cin, cout)
            picked += port and tsc.fwd_wins(k, cin, cout)
    assert picked > 0 or tdtype == torch.float16
    # cin mismatch and non-square kernels are refused by both
    assert not tsc.supported((4, 8, 32, 32), (16, 4, 3, 3), tdtype)
    assert not tsc.supported((4, 8, 32, 32), (16, 8, 3, 5), tdtype)
    # the serving path: head supported but plain; U4 and tail take the kernel
    if tdtype == torch.bfloat16:
        assert tsc.supported((4, 3, 256, 256), (64, 3, 7, 7), tdtype)
        assert not tsc.fwd_wins(7, 3, 64)
        assert tsc.supported((4, 32, 256, 256), (64, 32, 3, 3), tdtype)
        assert tsc.supported((4, 64, 256, 256), (3, 64, 7, 7), tdtype)


def test_in_act_slab_rule_matches_jax():
    shapes = [(4, 16, 16, 1024), (4, 32, 32, 512), (4, 32, 32, 256),
              (4, 16, 16, 512), (4, 256, 256, 64), (4, 128, 128, 128),
              (2, 4, 4, 256), (1, 7, 9, 3), (1, 512, 512, 1), (1, 513, 512, 1)]
    for n, h, w, c in shapes:
        ref = jin._slab_fits_vmem(jax.ShapeDtypeStruct((n, h, w, c),
                                                       jnp.bfloat16))
        assert tin.slab_fits((n, c, h, w)) == ref, (n, h, w, c)
    assert tin.slab_fits((4, 1024, 16, 16))          # the five serving sites
    assert not tin.slab_fits((4, 512, 32, 32))


# ---------------------------------------------------------------------------
# the kernel loader
# ---------------------------------------------------------------------------


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_kernel_library_is_keyed_by_sources(tmp_path):
    path = kernels.library_path(tmp_path)
    assert path.parent == tmp_path
    assert path.name.startswith("vct_kernels_") and path.suffix == ".so"
    assert path == kernels.library_path(tmp_path)
    names = {p.name for p in kernels._sources()}
    assert {"in_act.cu", "starved_conv.cu", "starved_dw.cu",
            "common.cuh"} <= names


def test_port_imports_no_jax():
    """Every module of the port, the data-parallel ones (``parallel.dp``,
    ``parallel.mesh``) among them, imports without pulling in JAX or the
    JAX package (the card's machine has no JAX)."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import vae_cyclegan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'vae_cyclegan_tpu')]\n"
        "assert not bad, bad\n"
        "assert {p.__name__ + '.parallel.dp', p.__name__ + '.parallel.mesh'}"
        " <= set(sys.modules)\n"
        "print('ok', len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
