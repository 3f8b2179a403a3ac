"""The conv prototypes of ``experiments/`` in the port
(``vae_cyclegan_tpu_torch.experiments``) against the JAX scripts.

The JAX functions run on the CPU in Pallas interpret mode: ``pallas_call`` is
patched to ``interpret=True`` for the test (the scripts look it up at call
time), and nothing in ``experiments/`` changes. The scripts are loaded from
their files; ``experiments/dw_dot_probe.py`` runs its six full-size probes
when imported, so only its imports and ``make`` are compiled from its source.
The port's functions take their plain versions on the CPU; the kernels
themselves are checked on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import ast
import functools
import importlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vae_cyclegan_tpu_torch.experiments import (
    common,
    conv_proto,
    dw_dot_probe,
    lowcin_conv2,
    lowcin_conv3,
)

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
# (h, w, cin, cout, k, R) at batch 2: a non-square plane, cin off the
# multiple of 8, k = 3, 5, 7
CASES = [(16, 16, 3, 8, 7, 8), (16, 24, 8, 4, 3, 8), (32, 40, 5, 6, 5, 16)]
# the port's conv functions and the JAX script each is held to
CONVS = {
    "conv_proto": (conv_proto.pallas_reflect_conv_fwd, "pallas_conv_proto",
                   "pallas_reflect_conv_fwd"),
    "lowcin_conv2": (lowcin_conv2.lowcin_conv, "pallas_conv2", "lowcin_conv"),
    "lowcin_conv3": (lowcin_conv3.lowcin_conv, "pallas_conv3", "lowcin_conv"),
}
TINY = [("tiny k7", 16, 3, 8, 7, 8), ("tiny k3", 16, 8, 4, 3, 8)]


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode for this test only."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", EXPERIMENTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _jax_make():
    """``make`` of experiments/dw_dot_probe.py, compiled with the script's
    imports only (its module level runs the full-size probes)."""
    path = EXPERIMENTS / "dw_dot_probe.py"
    tree = ast.parse(path.read_text())
    body = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom))
            or (isinstance(node, ast.FunctionDef) and node.name == "make")]
    namespace = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         namespace)
    return namespace["make"]


def _operands(case, dtype, seed=0):
    """x (2, h, w, cin) and w (k, k, cin, cout) from numpy, rounded to
    `dtype` once: the torch tensors and the JAX arrays hold the same
    values."""
    h, wd, cin, cout, k, _ = case
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, h, wd, cin)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((k, k, cin, cout)) * 0.1)
                         .astype(np.float32)).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return x, w, jnp.asarray(x.float().numpy(), jdt), jnp.asarray(
        w.float().numpy(), jdt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("name", list(CONVS))
def test_conv_prototype_matches_jax_interpret(interpret, name, case, dtype):
    """f32: atol 1e-5, rtol 1e-5 (the two sum in other orders; measured
    within 2.4e-6). bf16: every element within one bf16 rounding at its
    magnitude (rtol 2^-7) of JAX's, plus the f32 band (1e-5) for the
    elements near zero, where a rounding of a sum that differs in its last
    f32 bits is not relative to the element."""
    fn, script, jax_name = CONVS[name]
    R = case[-1]
    x, w, jx, jw = _operands(case, dtype)
    got = fn(x, w, R)
    want = np.asarray(getattr(_jax_script(script), jax_name)(jx, jw, R=R))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("mk,nk,kk,steps", [(24, 16, 40, 3), (8, 24, 72, 5)])
def test_dot_probe_matches_jax_interpret(interpret, mk, nk, kk, steps):
    """All-ones operands (the probe's own): exact, every sum an integer. Random
    bf16 operands: within rtol 1e-5, with an atol of 1e-5 of the largest
    element for the sums near zero (the two add the products in other
    orders)."""
    jmake = _jax_make()
    f = dw_dot_probe.make(mk, nk, kk, steps)
    p = torch.ones((mk, kk), dtype=torch.bfloat16)
    g = torch.ones((nk, kk), dtype=torch.bfloat16)
    want = np.asarray(jmake(mk, nk, kk, steps)(jnp.ones((mk, kk), jnp.bfloat16),
                                               jnp.ones((nk, kk), jnp.bfloat16)))
    got = f(p, g)
    assert got.dtype == torch.float32 and tuple(got.shape) == (mk, nk)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.full((mk, nk), steps * kk))

    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal((mk, kk)).astype(
        np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((nk, kk)).astype(
        np.float32)).bfloat16()
    want = np.asarray(jmake(mk, nk, kk, steps)(
        jnp.asarray(p.float().numpy(), jnp.bfloat16),
        jnp.asarray(g.float().numpy(), jnp.bfloat16)))
    np.testing.assert_allclose(f(p, g).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_prep_layouts_match_jax():
    """prep_x keeps JAX's layout (channel-major, cin zero-padded to 8, each
    channel's reflect-padded plane flattened row by row) with the card's row
    width, w + 2p rounded up to 8 instead of 128, and its own zero tail:
    equal on the columns both hold, zero past them. prep_w is JAX's exactly."""
    jscript = _jax_script("pallas_conv2")
    for h, wd, cin, cout, k, _ in CASES:
        x, w, jx, jw = _operands((h, wd, cin, cout, k, 0), torch.float32)
        p = k // 2
        _, cin_p, wp, tail = lowcin_conv2.geometry(wd, cin, k)
        got = lowcin_conv2.prep_x(x, k)
        want = np.asarray(jscript.prep_x(jx, k))
        jwp = (want.shape[-1] - 128) // (h + 2 * p)
        assert got.shape == (2, cin_p, (h + 2 * p) * wp + tail)
        assert want.shape[:2] == (2, cin_p) and wp % 8 == 0 and tail >= 2 * p
        gp = got[:, :, :(h + 2 * p) * wp].reshape(2, cin_p, h + 2 * p, wp)
        wnt = want[:, :, :(h + 2 * p) * jwp].reshape(2, cin_p, h + 2 * p, jwp)
        np.testing.assert_array_equal(gp[..., :wd + 2 * p].numpy(),
                                      wnt[..., :wd + 2 * p])
        assert not gp[..., wd + 2 * p:].any() and not got[..., -tail:].any()
        np.testing.assert_array_equal(lowcin_conv2.prep_w(w, cin_p).numpy(),
                                      np.asarray(jscript.prep_w(jw, cin_p)))


@pytest.mark.parametrize("k,cin,cout", [(7, 3, 64), (3, 64, 128), (3, 32, 64),
                                         (7, 64, 3), (5, 5, 6), (3, 8, 8)])
def test_nhwc_weight_keeps_each_tpu_kernels_contraction_order(k, cin, cout):
    """The weight of the NHWC conv core (K5, K7), bf16: cin zero-padded to
    whole 16-byte chunks (8 channels), the taps in K5's im2col order (dy,
    dx, ci), the rows of ``pallas_conv_proto``'s ``w.reshape(k*k*cin,
    cout)``, or in K7's (dx, dy, ci), the rows of JAX's
    ``pallas_conv2.prep_w`` laid side by side; where k * cout <= FOLD_COLS
    the dx taps fold into the rows, (co, dx) x (dy, ci). Exact."""
    x, w, jx, jw = _operands((8, 8, cin, cout, k, 0), torch.bfloat16)
    cin_p = -(-cin // 8) * 8
    wpad = np.zeros((k, k, cin_p, cout), np.float32)
    wpad[:, :, :cin] = w.float().numpy()
    fold = k * cout <= common.FOLD_COLS
    k5, fold5 = common.nhwc_weight(w, dx_outer=False)
    k7, fold7 = common.nhwc_weight(w, dx_outer=True)
    assert fold5 == fold7 == fold and k5.dtype == k7.dtype == torch.bfloat16
    if fold:
        want = wpad.transpose(3, 1, 0, 2).reshape(cout * k, k * cin_p)
        np.testing.assert_array_equal(k5.float().numpy(), want)
        np.testing.assert_array_equal(k7.float().numpy(), want)
        return
    np.testing.assert_array_equal(
        k5.float().numpy(), wpad.reshape(k * k * cin_p, cout).T)
    jdx = np.asarray(_jax_script("pallas_conv2").prep_w(jw, cin_p),
                     np.float32)  # (k_dx, cout, k_dy * cin_p)
    np.testing.assert_array_equal(
        k7.float().numpy(), jdx.transpose(1, 0, 2).reshape(cout, -1))
    if cin == cin_p:
        np.testing.assert_array_equal(
            k5.float().numpy(),
            np.asarray(jw, np.float32).reshape(k * k * cin, cout).T)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_kernel_inputs_hold_the_reflect_pad(case):
    """K5's padded input (what its kernel reads) is F.pad's reflect pad
    plus one zero row, flattened per row: exact."""
    h, wd, cin, cout, k, _ = case
    x, _, _, _ = _operands(case, torch.float32)
    p = k // 2
    want = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
                                   mode="reflect")
    want = torch.nn.functional.pad(want, (0, 0, 0, 1)).permute(0, 2, 3, 1)
    got = conv_proto.pad_input(x, k)
    assert got.shape == (2, h + 2 * p + 1, (wd + 2 * p) * cin)
    torch.testing.assert_close(got, want.reshape(got.shape), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_wp_wide_pad_is_jax_channel_major_input(case, dtype):
    """K6's input, ``common.pad_input`` at a row width of Wp, transposed to
    channel-major with cin zero-padded to cin_p, is JAX's
    ``pallas_conv2.prep_x`` exactly: at JAX's own Wp (w + 2p rounded up to
    128) over the (h + 2p) * Wp + 128 elements prep_x holds, the rest of
    the zero row zeros; at the card's Wp (rounded up to 8) the port's
    ``prep_x``, which the plain version reads."""
    h, wd, cin, _, k, _ = case
    x, _, jx, _ = _operands(case, dtype)
    p = k // 2
    _, cin_p, wp, _ = lowcin_conv2.geometry(wd, cin, k)

    def channel_major(width):
        xp = common.pad_input(x, k, width)
        assert xp.shape == (2, h + 2 * p + 1, width * cin)
        cm = xp.view(2, h + 2 * p + 1, width, cin).permute(0, 3, 1, 2)
        return torch.nn.functional.pad(cm.reshape(2, cin, -1),
                                       (0, 0, 0, cin_p - cin))

    jwp = -(-(wd + 2 * p) // 128) * 128
    want = np.asarray(_jax_script("pallas_conv2").prep_x(jx, k), np.float32)
    got = channel_major(jwp).float().numpy()
    assert want.shape == (2, cin_p, (h + 2 * p) * jwp + 128)
    np.testing.assert_array_equal(got[..., :want.shape[-1]], want)
    assert not got[..., want.shape[-1]:].any()
    got, mine = channel_major(wp), lowcin_conv2.prep_x(x, k)
    assert got.dtype == mine.dtype == dtype
    torch.testing.assert_close(got[..., :mine.shape[-1]], mine, atol=0,
                               rtol=0)
    assert not got[..., mine.shape[-1]:].any()


def test_channel_major_plain_version_holds_every_column():
    """K6's plain version in the kernel's layout: its w real columns are the
    conv; every column is the tap sum over the flat input, wrapping into the
    next row past w (checked against a loop over the taps)."""
    h, wd, cin, cout, k, _ = CASES[2]
    x, w, _, _ = _operands(CASES[2], torch.float32)
    cm = lowcin_conv2.lowcin_conv_cm_reference(x, w)
    _, cin_p, wp, _ = lowcin_conv2.geometry(wd, cin, k)
    assert cm.shape == (2, cout, h * wp)
    real = cm.reshape(2, cout, h, wp)[..., :wd].permute(0, 2, 3, 1)
    torch.testing.assert_close(real, conv_proto.reflect_conv_reference(x, w),
                               atol=1e-5, rtol=1e-5)
    xf = lowcin_conv2.prep_x(x, k)
    wdx = lowcin_conv2.prep_w(w, cin_p)
    loop = torch.zeros(2, cout, h * wp)
    for dx in range(k):
        for dy in range(k):
            for ci in range(cin_p):
                patch = xf[:, ci, dy * wp + dx: dy * wp + dx + h * wp]
                loop += wdx[dx, :, dy * cin_p + ci][None, :, None] * patch[:,
                                                                           None]
    torch.testing.assert_close(cm, loop, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_prototypes_refuse_what_jax_leaves_unwritten(name):
    """R not dividing h leaves JAX's last rows unwritten (its grid is
    h // R); a reflect pad of k // 2 >= min(h, w) has no meaning. Both raise
    ValueError, on every device."""
    fn = CONVS[name][0]
    x, w, _, _ = _operands(CASES[0], torch.float32)
    with pytest.raises(ValueError, match="does not divide"):
        fn(x, w, 5)
    with pytest.raises(ValueError, match="reflect pad"):
        fn(x[:, :, :3], w, 8)


def test_kernel_wrappers_refuse_cpu_tensors():
    x, w, _, _ = _operands(CASES[0], torch.float32)
    for wrapper in (conv_proto.conv_proto_cuda,
                    lowcin_conv2.lowcin_conv_cm_cuda,
                    lowcin_conv3.lowcin_conv_nhwc_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(x, w, 8)
        assert wrapper.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        dw_dot_probe.dot_probe_cuda(torch.ones(4, 8), torch.ones(2, 8), 2)
    with pytest.raises(ValueError, match="made for"):
        dw_dot_probe.make(4, 2, 8, 2)(torch.ones(4, 9), torch.ones(2, 9))


MAINS = {
    "conv_proto": (conv_proto.main, TINY),
    "lowcin_conv2": (lowcin_conv2.main, TINY),
    "lowcin_conv3": (lowcin_conv3.main, TINY),
    "dw_dot_probe": (dw_dot_probe.main, [("tiny probe", 8, 16, 40, 3)]),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_entry_point_runs_the_plain_versions_on_request(name, capsys):
    main, shapes = MAINS[name]
    results = main(["--device", "cpu", "--batch", "1"], shapes=shapes)
    assert [r["name"] for r in results] == [s[0] for s in shapes]
    for r in results:
        err = r.get("err", r.get("relerr"))
        assert np.isfinite(err) and err <= 1e-2
        assert r["ms"] is None and r["calls"] == 1  # no timing off the card
    assert "not measured" in capsys.readouterr().out


@pytest.mark.parametrize("name", list(MAINS))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    """Without --device the entry points take the card, and without a CUDA
    device they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MAINS[name][0]([])


def test_probe_sweep_needs_the_card():
    """``--sweep`` times launch plans; off the card it raises rather than
    time the plain version."""
    with pytest.raises(RuntimeError, match="CUDA device only"):
        dw_dot_probe.main(["--device", "cpu", "--sweep"])


def test_importing_the_probe_runs_nothing(capsys):
    importlib.reload(dw_dot_probe)
    assert capsys.readouterr().out == ""
    assert len(dw_dot_probe.SHAPES) == 6
    assert [s[3] for s in dw_dot_probe.SHAPES] == [4198, 4198, 5764, 5764,
                                                   8226, 9252]
