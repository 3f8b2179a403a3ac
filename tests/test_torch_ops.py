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
    assert {"in_act.cu", "starved_conv.cu", "common.cuh"} <= names


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX or the JAX
    package (the card's machine has no JAX)."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import vae_cyclegan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'vae_cyclegan_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
