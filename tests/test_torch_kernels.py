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
    reflect_conv_cuda,
    starved_reflect_conv,
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
    with pytest.raises(RuntimeError, match="forward-only"):
        in_act_cuda(x.requires_grad_(), "relu", "act_norm")
    x = _randn((2, 8, 32, 32), 7, cuda, torch.float32)
    w = _randn((16, 8, 3, 3), 8, cuda, torch.float32)
    with pytest.raises(TypeError):
        reflect_conv_cuda(x, w.bfloat16())
    with pytest.raises(ValueError):
        reflect_conv_cuda(x, w[:, :, :2, :2].contiguous())
    with pytest.raises(RuntimeError, match="forward-only"):
        reflect_conv_cuda(x, w.requires_grad_())


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
