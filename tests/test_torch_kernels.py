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
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.ops.instance_norm import (
    fused_reference,
    in_act_cuda,
    instance_norm_act,
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
# (1, 2, 8, 1535): 12280 elements, the largest plane held in shared memory;
# (1, 3, 96, 128): 12288, just past it, so it loops over device memory
@pytest.mark.parametrize("shape", [(4, 1024, 16, 16), (2, 8, 16, 16),
                                   (2, 3, 7, 9), (1, 4, 128, 128),
                                   (1, 2, 8, 1535), (1, 3, 96, 128)])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "sigmoid",
                                 "identity"])
@pytest.mark.parametrize("order", ["norm_act", "act_norm"])
def test_in_act_kernel_matches_plain(cuda, shape, dtype, act, order):
    x = _randn(shape, 0, cuda, dtype, 2.0) + 0.5
    _assert_close(in_act_cuda(x, act, order), fused_reference(x, act, order))


# tests/test_starved_conv.py CONV_CASES (h, w, cin, cout, k) and the
# serving path's U4 and tail
CONV_CASES = [(32, 40, 3, 16, 7), (32, 40, 16, 3, 7), (32, 32, 8, 16, 3),
              (32, 32, 16, 8, 3), (48, 40, 3, 8, 5), (40, 48, 4, 8, 3),
              (256, 256, 32, 64, 3), (256, 256, 64, 3, 7)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,cin,cout,k", CONV_CASES)
def test_starved_conv_kernel_matches_plain(cuda, h, w, cin, cout, k, dtype):
    x = _randn((2, cin, h, w), 1, cuda, dtype)
    wgt = _randn((cout, cin, k, k), 2, cuda, dtype,
                 (2.0 / (cout * k * k)) ** 0.5)
    _assert_close(reflect_conv_cuda(x, wgt), reflect_conv(x, wgt))


@pytest.mark.parametrize("mode", ["zero_same", "zero"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,cin,cout,k", CONV_CASES)
def test_zero_conv_kernel_matches_plain(cuda, h, w, cin, cout, k, dtype,
                                        mode):
    x = _randn((2, cin, h, w), 11, cuda, dtype)
    wgt = _randn((cout, cin, k, k), 12, cuda, dtype,
                 (2.0 / (cout * k * k)) ** 0.5)
    _assert_close(zero_conv_cuda(x, wgt, mode), zero_conv(x, wgt, mode))


# the training path's dw sites (head, U4, tail at 256x256) and CONV_CASES
DW_CASES = CONV_CASES + [(256, 256, 3, 64, 7)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,cin,cout,k", DW_CASES)
def test_dw_kernel_matches_plain(cuda, h, w, cin, cout, k, dtype):
    """f32 out of both: they differ in summation order only, over n*h*w
    products (131,072 at 256x256), so the bound is relative to the largest
    weight gradient: 1e-4 of it in f32; bf16 inputs are the same values in
    both, so the same bound holds."""
    x = _randn((2, cin, h, w), 13, cuda, dtype)
    g = _randn((2, cout, h, w), 14, cuda, dtype)
    got, want = dw_cuda(x, g, k), dw_reference(x, g, k)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (cout, cin, k, k)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    # two passes in a fixed order: bit for bit the same on a rerun
    assert torch.equal(dw_cuda(x, g, k), got)


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


def test_slice_on_cuda_launches_each_picked_site_and_matches_cpu(cuda):
    model = ModelConfig(64, 8, 16)
    gpu = create_task("cyclevaegan", model=model, device=cuda)
    cpu = create_task("cyclevaegan", model=model)
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
