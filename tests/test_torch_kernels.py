"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides inside the ``cuda`` fixture whether a card
is present and skips without one. The card's machine has no JAX, so this
file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from vae_cyclegan_tpu_torch import kernels
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.experiments import (
    conv_proto,
    dw_dot_probe,
    lowcin_conv2,
    lowcin_conv3,
)
from vae_cyclegan_tpu_torch.experiments.common import reflect_conv_reference
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.ops.instance_norm import (
    ACTS,
    ORDERS,
    fused_reference,
    in_act_cuda,
    in_act_tiled_cuda,
    instance_norm_act,
    plane_plan,
    tiled_reference,
)
from vae_cyclegan_tpu_torch.ops.reflect_conv import reflect_conv
from vae_cyclegan_tpu_torch.ops.starved_conv import (
    dw_cuda,
    dw_reference,
    reflect_conv_cuda,
    starved_reflect_conv,
    zero_conv,
    zero_conv_cuda,
)

pytestmark = pytest.mark.gpu

# |kernel - plain| <= atol + rtol * |plain|: f32 differs in summation order
# only, bf16 also in where the f32 result rounds (1 ulp <= 2^-7 relative)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels build with nvcc for sm_90a)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    return torch.device("cuda")


def _randn(shape, seed, device, dtype, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device, dtype)


def _assert_close(got, want):
    atol, rtol = TOL[want.dtype]
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
# the serving path's planes (16x16), a plane that is not a multiple of the
# 16-byte vector (7x9), and planes of 12280 (a multiple of the vector, not
# of a CTA's 256 vectors) to 16384 elements: a CTA per plane in bf16, a
# cluster of CTAs in f32
@pytest.mark.parametrize("shape", [(4, 1024, 16, 16), (2, 8, 16, 16),
                                   (2, 3, 7, 9), (1, 4, 128, 128),
                                   (1, 2, 8, 1535), (1, 3, 96, 128)])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "sigmoid",
                                 "identity"])
@pytest.mark.parametrize("order", ["norm_act", "act_norm"])
def test_in_act_kernel_matches_plain(cuda, shape, dtype, act, order):
    """K1 against fused_reference; its sums run in a fixed order with no
    atomics, so a second launch gives the same bits."""
    x = _randn(shape, 0, cuda, dtype, 2.0) + 0.5
    got = in_act_cuda(x, act, order)
    _assert_close(got, fused_reference(x, act, order))
    assert torch.equal(in_act_cuda(x, act, order), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_in_act_kernel_takes_unaligned_views(cuda, dtype):
    """A view one element into its storage is not 16-byte aligned: K1 takes
    its one-element loads, and agrees."""
    base = _randn((2 * 64 * 32 * 32 + 1,), 24, cuda, dtype, 2.0)
    x = base[1:].view(2, 64, 32, 32)
    assert x.data_ptr() % 16 != 0
    _assert_close(in_act_cuda(x, "relu", "act_norm"),
                  fused_reference(x, "relu", "act_norm"))


# The IN kernels' regimes (csrc/in_plane.cuh), by bytes per plane: a warp per
# plane up to 2 KB, a CTA per plane up to 32 KB, a thread block cluster per
# plane up to 256 KB, a cluster looping over the plane beyond
PLANE_LIMITS = ((2 * 1024, "warp"), (32 * 1024, "block"),
                (256 * 1024, "cluster"))


def _regime(hw, dtype):
    nbytes = hw * torch.empty((), dtype=dtype).element_size()
    return next((name for limit, name in PLANE_LIMITS if nbytes <= limit),
                "stream")


def _plane_cases(dtype):
    """(dtype, shape) at each threshold of the regimes and one 16-byte vector
    either side (h = the vector's elements, w = 128 k - 1, 128 k, 128 k + 1:
    2, 32 and 256 KB at k = 1, 16, 128); planes whose hw is not a multiple
    of the vector (1023, 16383, 65535, 131769 elements: a regime each in
    bf16); 11 and 15 planes of 16x16, which do not fill the last block of
    eight warps."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    shapes = [(1, 3, vec, 128 * k + d) for k in (1, 16, 128)
              for d in (-1, 0, 1)]
    shapes += [(1, 3, 31, 33), (1, 2, 127, 129), (1, 2, 255, 257),
               (1, 2, 363, 363), (1, 11, 16, 16), (3, 5, 16, 16)]
    return [(dtype, shape) for shape in shapes]


PLANE_CASES = _plane_cases(torch.bfloat16) + _plane_cases(torch.float32)
IN_KERNELS = {"in_act": (in_act_cuda, fused_reference),
              "in_act_tiled": (in_act_tiled_cuda, tiled_reference)}


@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("dtype,shape", PLANE_CASES)
@pytest.mark.parametrize("kernel", list(IN_KERNELS))
def test_in_kernels_at_plane_regime_edges(cuda, kernel, dtype, shape, act,
                                          order):
    """K1 and K2 at the edges of their regimes: the plan the library takes
    is the regime the thresholds name; the kernel against its plain version,
    and bit for bit on a second launch."""
    launch, plain = IN_KERNELS[kernel]
    hw = shape[2] * shape[3]
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    assert plane_plan(hw, dtype, hw % vec == 0)["regime"] == _regime(hw, dtype)
    x = _randn(shape, 40, cuda, dtype, 2.0) + 0.5
    got = launch(x, act, order)
    _assert_close(got, plain(x, act, order))
    assert torch.equal(launch(x, act, order), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("side", [16, 32, 64, 128, 256])
def test_in_kernels_hold_the_path_planes_on_chip(cuda, side, dtype):
    """The path's planes: 16x16 and 32x32 bf16 a warp each, 64x64 and
    128x128 a CTA, 256x256 a cluster of 8 CTAs (f32, twice the bytes, a
    regime later): none loops over device memory."""
    plan = plane_plan(side * side, dtype)
    assert plan["vec"] == 16 // torch.empty((), dtype=dtype).element_size()
    assert plan["regime"] == _regime(side * side, dtype) != "stream"
    if side == 256:
        assert plan["regime"] == "cluster" and plan["cluster"] == 8


# the tiled configuration's sites at batch 2 (generator: 256x256x64 ...
# 16x16x1024; discriminator: 64x64x128 ... 16x16x512, among them) and edge
# shapes: planes that are not a multiple of the 16-byte vector (75x67 and
# 64x65: a CTA each, 9x9: a warp), one plane smaller than a warp's vectors
TILED_SHAPES = [(2, 64, 256, 256), (2, 128, 128, 128), (2, 256, 64, 64),
                (2, 512, 32, 32), (2, 1024, 16, 16), (2, 3, 75, 67),
                (3, 5, 64, 65), (1, 2, 9, 9)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", TILED_SHAPES)
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "sigmoid",
                                 "identity"])
@pytest.mark.parametrize("order", ["norm_act", "act_norm"])
def test_in_act_tiled_kernel_matches_plain(cuda, shape, dtype, act, order):
    """K2 against tiled_reference; its sums run in a fixed order with no
    atomics, so a second launch gives the same bits."""
    x = _randn(shape, 20, cuda, dtype, 2.0) + 0.5
    got = in_act_tiled_cuda(x, act, order)
    _assert_close(got, tiled_reference(x, act, order))
    assert torch.equal(in_act_tiled_cuda(x, act, order), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_in_act_tiled_kernel_takes_unaligned_views(cuda, dtype):
    """A view one element into its storage is not 16-byte aligned: the
    kernel takes its one-element path, and agrees."""
    base = _randn((2 * 64 * 64 * 64 + 1,), 21, cuda, dtype, 2.0)
    x = base[1:].view(2, 64, 64, 64)
    assert x.data_ptr() % 16 != 0
    _assert_close(in_act_tiled_cuda(x, "relu", "act_norm"),
                  tiled_reference(x, "relu", "act_norm"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act,order", [("relu", "act_norm"),
                                       ("identity", "act_norm"),
                                       ("leaky_relu", "norm_act")])
def test_in_act_tiled_function_gradients_match_plain_autograd(cuda, dtype, act,
                                                              order):
    """instance_norm_act under "tiled" at a 128x128x64 slab: one K2 launch,
    y against tiled_reference and dx (the centered backward) against
    autograd of tiled_reference."""
    x = _randn((2, 64, 128, 128), 22, cuda, dtype, 2.0) + 0.5
    gy = _randn((2, 64, 128, 128), 23, cuda, dtype)
    before = in_act_tiled_cuda.launches
    xa = x.clone().requires_grad_()
    y = instance_norm_act(xa, act=act, order=order, mode="tiled")
    (dx,) = torch.autograd.grad(y, xa, gy)
    assert in_act_tiled_cuda.launches == before + 1
    xb = x.clone().requires_grad_()
    y_ref = tiled_reference(xb, act, order)
    (dx_ref,) = torch.autograd.grad(y_ref, xb, gy)
    _assert_close(y, y_ref)
    _assert_close(dx, dx_ref)


# tests/test_starved_conv.py CONV_CASES (h, w, cin, cout, k) and the
# serving path's U4 and tail
CONV_CASES = [(32, 40, 3, 16, 7), (32, 40, 16, 3, 7), (32, 32, 8, 16, 3),
              (32, 32, 16, 8, 3), (48, 40, 3, 8, 5), (40, 48, 4, 8, 3),
              (256, 256, 32, 64, 3), (256, 256, 64, 3, 7)]
# shapes that cross the conv kernel's tiles (bf16: 4 output rows x 64
# columns, f32: 2 x 32; N tiles of 8, 32 or 64 channels, or, in bf16 where
# k * cout <= 24, the taps folded into N): cout past one N tile and not a
# multiple of it, h not a multiple of the rows (35: odd, so not of the f32
# rows either) and w not of the columns (45: nor of the 16-byte loads), in
# both forms, and cin 128 (folded) and 256 (not), whose weights and slab do
# not fit shared memory together, so the K loop walks two channel chunks
K3_EDGES = [(38, 72, 16, 80, 3), (35, 45, 5, 24, 5), (35, 45, 8, 3, 5),
            (34, 40, 128, 3, 7), (32, 40, 256, 16, 3)]


def _check_conv(got, want, launch):
    """The kernel against its plain version, and a second launch bit for
    bit (the K loop sums in one fixed order)."""
    _assert_close(got, want)
    assert torch.equal(launch(), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,cin,cout,k", CONV_CASES + K3_EDGES)
def test_starved_conv_kernel_matches_plain(cuda, h, w, cin, cout, k, dtype):
    x = _randn((2, cin, h, w), 1, cuda, dtype)
    wgt = _randn((cout, cin, k, k), 2, cuda, dtype,
                 (2.0 / (cout * k * k)) ** 0.5)
    _check_conv(reflect_conv_cuda(x, wgt), reflect_conv(x, wgt),
                lambda: reflect_conv_cuda(x, wgt))


@pytest.mark.parametrize("mode", ["zero_same", "zero"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,cin,cout,k", CONV_CASES + K3_EDGES)
def test_zero_conv_kernel_matches_plain(cuda, h, w, cin, cout, k, dtype,
                                        mode):
    x = _randn((2, cin, h, w), 11, cuda, dtype)
    wgt = _randn((cout, cin, k, k), 12, cuda, dtype,
                 (2.0 / (cout * k * k)) ** 0.5)
    _check_conv(zero_conv_cuda(x, wgt, mode), zero_conv(x, wgt, mode),
                lambda: zero_conv_cuda(x, wgt, mode))


# the training path's dw sites (head, U4, tail at 256x256) and CONV_CASES
DW_CASES = CONV_CASES + [(256, 256, 3, 64, 7)]
# shapes that cross the dw kernel's tiles, (n, h, w, cin, cout, k): M tiles
# of 64 output channels (cout 24, 80: not a multiple of 16) against N tiles
# of up to 160 (ci, dy, dx) columns (cin*k*k = 125 and 144: not a multiple
# of 8; cin 256: 16 N tiles), or, where k * cout <= 24, the taps folded (M
# tiles of up to 128 (dy, ci) rows: cin 128 gives 8); odd h (35) and w (45),
# whose rows are not 16-byte aligned (staged element by element); rows past
# one 256-column chunk (520, and 264, whose last chunk is 8 columns); n = 1
DW_EDGES = [(1, 35, 45, 5, 24, 5), (2, 38, 72, 16, 80, 3),
            (1, 34, 40, 128, 3, 7), (2, 32, 40, 256, 16, 3),
            (1, 35, 45, 8, 3, 5), (1, 16, 520, 4, 16, 3),
            (1, 12, 264, 8, 3, 7)]


def _check_dw(n, h, w, cin, cout, k, dtype, device):
    """f32 out of both: they differ in summation order only, over n*h*w
    products (131,072 at 256x256), so the bound is relative to the largest
    weight gradient: 1e-4 of it in f32; bf16 inputs are the same values in
    both, so the same bound holds."""
    x = _randn((n, cin, h, w), 13, device, dtype)
    g = _randn((n, cout, h, w), 14, device, dtype)
    got, want = dw_cuda(x, g, k), dw_reference(x, g, k)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (cout, cin, k, k)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    # two passes in a fixed order: bit for bit the same on a rerun
    assert torch.equal(dw_cuda(x, g, k), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,cin,cout,k", DW_CASES)
def test_dw_kernel_matches_plain(cuda, h, w, cin, cout, k, dtype):
    _check_dw(2, h, w, cin, cout, k, dtype, cuda)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h,w,cin,cout,k", DW_EDGES)
def test_dw_kernel_matches_plain_at_edges(cuda, n, h, w, cin, cout, k, dtype):
    _check_dw(n, h, w, cin, cout, k, dtype, cuda)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,cin,cout,k", CONV_CASES)
def test_conv_function_gradients_match_plain_autograd(cuda, h, w, cin, cout,
                                                      k, dtype):
    """starved_reflect_conv's (y, dx, dw) against autograd of the plain
    reflect conv, on the same inputs and cotangent. In bf16 the port rounds
    the fold's interior and each border strip to bf16 before adding them
    (as the JAX package does), the plain backward rounds once per conv: a
    border element may be off by a rounding of its largest term, so dx gets
    one ulp at its largest magnitude plus two of its own."""
    x = _randn((2, cin, h, w), 15, cuda, dtype)
    wgt = _randn((cout, cin, k, k), 16, cuda, dtype,
                 (2.0 / (cout * k * k)) ** 0.5)
    gy = _randn((2, cout, h, w), 17, cuda, dtype)
    before = (reflect_conv_cuda.launches, zero_conv_cuda.launches,
              dw_cuda.launches)
    xa, wa = x.clone().requires_grad_(), wgt.clone().requires_grad_()
    y = starved_reflect_conv(xa, wa)
    dx, dw = torch.autograd.grad(y, (xa, wa), gy)
    xb, wb = x.clone().requires_grad_(), wgt.clone().requires_grad_()
    y_ref = reflect_conv(xb, wb)
    dx_ref, dw_ref = torch.autograd.grad(y_ref, (xb, wb), gy)
    launched = (reflect_conv_cuda.launches - before[0],
                zero_conv_cuda.launches - before[1],
                dw_cuda.launches - before[2])
    assert launched == (int(cin >= 8), 1, 1)
    _assert_close(y, y_ref)
    if dtype == torch.float32:
        _assert_close(dx, dx_ref)
    else:
        assert dx.dtype == dx_ref.dtype
        torch.testing.assert_close(
            dx.float(), dx_ref.float(), rtol=2 ** -6,
            atol=2 ** -7 * float(dx_ref.abs().max()))
    atol = (1e-4 if dtype == torch.float32 else 1e-2) * float(
        dw_ref.abs().max())
    torch.testing.assert_close(dw.float(), dw_ref.float(), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 1024, 16, 16), (2, 64, 128, 128)])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "identity"])
@pytest.mark.parametrize("order", ["norm_act", "act_norm"])
def test_in_act_function_gradients_match_plain_autograd(cuda, shape, dtype,
                                                        act, order):
    """instance_norm_act's (y, dx), kernel site (16x16x1024) and big slab
    (128x128x64, plain), against autograd of the plain version."""
    x = _randn(shape, 18, cuda, dtype, 2.0) + 0.5
    gy = _randn(shape, 19, cuda, dtype)
    xa = x.clone().requires_grad_()
    y = instance_norm_act(xa, act=act, order=order)
    (dx,) = torch.autograd.grad(y, xa, gy)
    xb = x.clone().requires_grad_()
    y_ref = fused_reference(xb, act, order)
    (dx_ref,) = torch.autograd.grad(y_ref, xb, gy)
    _assert_close(y, y_ref)
    _assert_close(dx, dx_ref)


def test_dispatchers_launch_the_kernels_on_cuda(cuda):
    x = _randn((2, 64, 16, 16), 3, cuda, torch.bfloat16)
    before = in_act_cuda.launches
    y = instance_norm_act(x, act="relu", order="act_norm")
    assert in_act_cuda.launches == before + 1
    _assert_close(y, fused_reference(x, "relu", "act_norm"))
    x = _randn((2, 32, 64, 64), 4, cuda, torch.bfloat16)
    w = _randn((64, 32, 3, 3), 5, cuda, torch.bfloat16, 0.05)
    before = reflect_conv_cuda.launches
    y = starved_reflect_conv(x, w)
    assert reflect_conv_cuda.launches == before + 1
    _assert_close(y, reflect_conv(x, w))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = _randn((2, 8, 16, 16), 6, cuda, torch.float32)
    with pytest.raises(TypeError):
        in_act_cuda(x.half(), "relu", "act_norm")
    with pytest.raises(ValueError):
        in_act_cuda(x.transpose(2, 3), "relu", "act_norm")
    with pytest.raises(RuntimeError, match="not differentiable"):
        in_act_cuda(x.requires_grad_(), "relu", "act_norm")
    x = _randn((2, 8, 16, 16), 6, cuda, torch.float32)
    with pytest.raises(TypeError):
        in_act_tiled_cuda(x.half(), "relu", "act_norm")
    with pytest.raises(ValueError):
        in_act_tiled_cuda(x.transpose(2, 3), "relu", "act_norm")
    with pytest.raises(ValueError, match="CUDA"):
        in_act_tiled_cuda(x.cpu(), "relu", "act_norm")
    with pytest.raises(RuntimeError, match="not differentiable"):
        in_act_tiled_cuda(x.requires_grad_(), "relu", "act_norm")
    x = _randn((2, 8, 32, 32), 7, cuda, torch.float32)
    w = _randn((16, 8, 3, 3), 8, cuda, torch.float32)
    with pytest.raises(TypeError):
        reflect_conv_cuda(x, w.bfloat16())
    with pytest.raises(ValueError):
        reflect_conv_cuda(x, w[:, :, :2, :2].contiguous())
    with pytest.raises(RuntimeError, match="not differentiable"):
        reflect_conv_cuda(x, w.requires_grad_())
    with pytest.raises(ValueError):
        zero_conv_cuda(x, w, "reflect")
    with pytest.raises(TypeError):
        dw_cuda(x, _randn((2, 16, 32, 32), 9, cuda, torch.bfloat16), 3)
    with pytest.raises(ValueError):
        dw_cuda(x, _randn((2, 16, 32, 30), 9, cuda, torch.float32), 3)
    # k * k > 160 with unfolded taps: one channel's taps exceed an N tile
    with pytest.raises(ValueError):
        dw_cuda(x, _randn((2, 16, 32, 32), 9, cuda, torch.float32), 13)


def test_slice_on_cuda_launches_each_picked_site_and_matches_cpu(cuda):
    model = ModelConfig(64, 8, 16)
    gpu = create_task("cyclevaegan", model=model, device=cuda)
    cpu = create_task("cyclevaegan", model=model, device="cpu")
    gpu.init(0)
    cpu.init(0)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    eps = rng.randn(2, 4, 4, 8).astype(np.float32)
    before = (in_act_cuda.launches, reflect_conv_cuda.launches)
    with kernels.record_sites() as sites:
        got = gpu.generate({"x": x}, eps=eps)
    launched = (in_act_cuda.launches - before[0],
                reflect_conv_cuda.launches - before[1])
    assert launched == (sum(s[0] == "in_act" for s in sites),
                        sum(s[0] == "starved_conv" for s in sites))
    assert launched[0] > 0 and launched[1] > 0
    want = cpu.generate({"x": x}, eps=eps)
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-2)


def test_tiled_slice_on_cuda_launches_each_picked_site_and_matches_cpu(cuda):
    """generate under "tiled" at 64 px, base 16: K2 at every picked site
    and never K1; the card's f32 output against the CPU's."""
    model = ModelConfig(64, 8, 16, instance_norm="tiled")
    gpu = create_task("cyclevaegan", model=model, device=cuda)
    cpu = create_task("cyclevaegan", model=model, device="cpu")
    gpu.init(0)
    cpu.init(0)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    eps = rng.randn(2, 4, 4, 8).astype(np.float32)
    before = (in_act_cuda.launches, in_act_tiled_cuda.launches)
    with kernels.record_sites() as sites:
        got = gpu.generate({"x": x}, eps=eps)
    launched = (in_act_cuda.launches - before[0],
                in_act_tiled_cuda.launches - before[1])
    assert launched == (0, sum(s[0] == "in_act_tiled" for s in sites)) != (0, 0)
    want = cpu.generate({"x": x}, eps=eps)
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-2)


# the conv prototypes' kernels (K5-K7) at edge shapes, (h, w, cin, cout, k,
# R): k = 7, 5, 3; cin = 3, 5, 8 and the paths' 32 and 64; widths off the
# multiple of 8; two R per shape. For the NHWC core of K5 and K7: cin 3 and
# 5 take its register-staged loader, 8, 32 and 64 its cp.async one; cout 3
# (k 3 and 7), 6 (k 5) and 8 (k 3) fold the dx taps into N, 6 and 8 at k 7
# and 16 take the narrow tiles, 80 and 128 the 128-wide one (80: a ragged
# channel tile); widths 20, 36, 130 and 300 leave a ragged last column tile;
# 256 x 256 at cin 8 gives more tiles than a block's two-slab ring holds.
# For K6's flat Wp-wide loader: w + 2p already a multiple of 8 (26 at k 7,
# 30 at k 3, 18 at k 7 folded: no zero columns) and not (13 at k 5, 9 at k
# 7, 10 at k 3); h = 3, 5, 6, 7, 9, which the card's bands of 2 or 4 rows do
# not divide, so the last band's slab runs past the zero row (whose taps the
# last row's wrap columns read) and past the image; a row narrower than one
# 256-column tile (9, 10), and the 128-wide tile
PROTO_CASES = [(16, 20, 3, 8, 7, 8), (16, 20, 3, 8, 7, 16),
               (24, 30, 5, 6, 5, 8), (24, 30, 5, 6, 5, 12),
               (32, 36, 8, 16, 3, 16), (32, 36, 8, 16, 3, 4),
               (16, 24, 64, 3, 7, 8), (32, 32, 32, 64, 3, 16),
               (8, 130, 64, 128, 3, 8), (6, 300, 64, 80, 3, 6),
               (10, 36, 32, 3, 3, 10), (8, 20, 8, 6, 7, 8),
               (12, 20, 5, 8, 3, 4), (256, 256, 8, 64, 3, 16),
               (4, 26, 8, 16, 7, 4), (6, 30, 64, 3, 3, 3),
               (5, 18, 64, 3, 7, 5), (3, 13, 5, 8, 5, 1),
               (7, 9, 3, 64, 7, 7), (9, 10, 32, 128, 3, 9)]
# The tightest reflection, h and w = k / 2 + 1 (k 3, 5, 7), on both loader
# paths and all tile kinds: K7 reflects in its loader, K6 reads rows of Wp
# = 8 with a zero column or more
REFLECT_EDGES = [(2, 2, 5, 8, 3, 2), (3, 3, 8, 64, 5, 3), (4, 4, 3, 80, 7, 4),
                 (4, 4, 32, 3, 7, 2), (2, 2, 64, 16, 3, 1)]
# kernel wrapper -> the plain version in the kernel's own output layout
PROTO_KERNELS = {
    "conv_proto": (conv_proto.conv_proto_cuda, reflect_conv_reference),
    "lowcin_conv_cm": (lowcin_conv2.lowcin_conv_cm_cuda,
                       lowcin_conv2.lowcin_conv_cm_reference),
    "lowcin_conv_nhwc": (lowcin_conv3.lowcin_conv_nhwc_cuda,
                         reflect_conv_reference),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,cin,cout,k,R", PROTO_CASES)
@pytest.mark.parametrize("name", list(PROTO_KERNELS))
def test_conv_prototype_kernel_matches_plain(cuda, name, h, w, cin, cout, k,
                                             R, dtype):
    """K5, K6 (channel-major, every Wp column) and K7 against their plain
    versions; no atomics, so a second launch gives the same bits."""
    kernel, plain = PROTO_KERNELS[name]
    x = _randn((2, h, w, cin), 30, cuda, dtype)
    wgt = _randn((k, k, cin, cout), 31, cuda, dtype, 0.05)
    before = kernel.launches
    got = kernel(x, wgt, R)
    _assert_close(got, plain(x, wgt))
    assert torch.equal(kernel(x, wgt, R), got)
    assert kernel.launches == before + 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,cin,cout,k,R", REFLECT_EDGES)
@pytest.mark.parametrize("name", ["lowcin_conv_nhwc", "lowcin_conv_cm"])
def test_lowcin_nhwc_kernel_reflects_at_the_tightest_planes(cuda, name, h, w,
                                                           cin, cout, k, R,
                                                           dtype):
    """K7 and K6 at planes one row and column wider than the reflect pad:
    every slab position reflects (K7), some twice over the plane; K6's
    rows are mostly wrap columns; bit for bit on a second launch."""
    kernel, plain = PROTO_KERNELS[name]
    x = _randn((2, h, w, cin), 38, cuda, dtype)
    wgt = _randn((k, k, cin, cout), 39, cuda, dtype, 0.05)
    got = kernel(x, wgt, R)
    _assert_close(got, plain(x, wgt))
    assert torch.equal(kernel(x, wgt, R), got)


@pytest.mark.parametrize("name", list(PROTO_KERNELS))
def test_conv_prototype_kernels_refuse_what_they_do_not_take(cuda, name):
    kernel = PROTO_KERNELS[name][0]
    x = _randn((2, 16, 20, 3), 32, cuda, torch.float32)
    wgt = _randn((7, 7, 3, 8), 33, cuda, torch.float32)
    with pytest.raises(ValueError, match="does not divide"):
        kernel(x, wgt, 5)
    with pytest.raises(ValueError, match="reflect pad"):
        kernel(x[:, :, :3].contiguous(), wgt, 8)
    with pytest.raises(TypeError):
        kernel(x, wgt.bfloat16(), 8)
    with pytest.raises(ValueError):
        kernel(x.transpose(1, 2), wgt, 8)
    with pytest.raises(RuntimeError, match="not differentiable"):
        kernel(x, wgt.requires_grad_(), 8)


# (mk, nk, kk, steps): ragged M, N and K; kk below one 16-slice per rank
# (8, 40: the plan shrinks the cluster); kk = 1, 7 and 15 mod 16 (97, 135,
# 303; odd kk takes the 2-byte loader); one step; the six probes' shapes
# (dw_dot_probe.SHAPES; the two wide ones are one shape) at two steps, and
# one of them at its 384 steps
PROBE_CASES = [(24, 40, 100, 3), (40, 24, 77, 2), (24, 40, 8, 3),
               (40, 24, 40, 2), (24, 40, 97, 2), (40, 24, 135, 3),
               (33, 70, 303, 2), (24, 40, 100, 1), (24, 448, 4198, 2),
               (448, 24, 4198, 2), (64, 152, 5764, 2), (96, 192, 8226, 2),
               (32, 576, 9252, 2), (24, 448, 4198, 384)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mk,nk,kk,steps", PROBE_CASES)
def test_dot_probe_kernel_matches_plain(cuda, mk, nk, kk, steps, dtype):
    """K8 (a cluster per output tile, dw_dot_probe.plan's): exact on
    all-ones operands (every sum an integer below 2^24); within rtol 1e-5 on
    random ones, with an atol of 1e-5 of the largest element for the sums
    near zero; bit for bit on a second launch."""
    p = torch.ones((mk, kk), dtype=dtype, device=cuda)
    g = torch.ones((nk, kk), dtype=dtype, device=cuda)
    got = dw_dot_probe.dot_probe_cuda(p, g, steps)
    assert got.dtype == torch.float32 and got.shape == (mk, nk)
    assert torch.equal(got, dw_dot_probe.dot_probe_reference(p, g, steps))
    p = _randn((mk, kk), 34, cuda, dtype)
    g = _randn((nk, kk), 35, cuda, dtype)
    got = dw_dot_probe.dot_probe_cuda(p, g, steps)
    want = dw_dot_probe.dot_probe_reference(p, g, steps)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(dw_dot_probe.dot_probe_cuda(p, g, steps), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dot_probe_kernel_takes_every_plan(cuda, dtype):
    """K8 under every launch dw_dot_probe.candidates gives with clusters of 1
    to 16 (tiles 16, 32 and 64 wide, clusters the plan never picks): exact
    on ones, within rtol 1e-5 on random operands."""
    mk, nk, kk, steps = 40, 70, 1000, 2
    ones = (torch.ones((mk, kk), dtype=dtype, device=cuda),
            torch.ones((nk, kk), dtype=dtype, device=cuda))
    p = _randn((mk, kk), 38, cuda, dtype)
    g = _randn((nk, kk), 39, cuda, dtype)
    want = dw_dot_probe.dot_probe_reference(p, g, steps)
    plans = dw_dot_probe.candidates(mk, nk, kk, dtype, range(1, 17))
    assert {pl.tn for pl in plans} == set(dw_dot_probe.TILE_NS)
    for pl in plans:
        got = dw_dot_probe.launch_plan(*ones, steps, pl)
        assert torch.equal(got, torch.full_like(got, steps * kk)), pl
        torch.testing.assert_close(
            dw_dot_probe.launch_plan(p, g, steps, pl), want, rtol=1e-5,
            atol=1e-5 * float(want.abs().max()), msg=str(pl))


def test_dot_probe_sweep_times_every_plan(cuda):
    """The entry point's --sweep on a small probe: one row per candidate
    plan, each exact on ones and timed, the plan's own marked."""
    shape = [("small", 24, 40, 100, 2)]
    rows = dw_dot_probe.sweep(cuda, shape)
    assert len(rows) == len(dw_dot_probe.candidates(24, 40, 100,
                                                    torch.bfloat16,
                                                    range(1, 17)))
    assert all(r["exact"] and r["ms"] > 0 and r["resident"] >= 1
               for r in rows)
    assert sum(r["planned"] for r in rows) == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_dot_probe_kernel_takes_unaligned_views(cuda, dtype):
    """Views one element into their storage (and an odd kk) are not 4-byte
    aligned: K8 loads them two bytes at a time, and agrees."""
    p = _randn((24 * 101 + 1,), 36, cuda, dtype)[1:].view(24, 101)
    g = _randn((40 * 101 + 1,), 37, cuda, dtype)[1:].view(40, 101)
    got = dw_dot_probe.dot_probe_cuda(p, g, 2)
    want = dw_dot_probe.dot_probe_reference(p, g, 2)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
