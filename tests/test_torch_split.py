"""K2's split pair on the CPU: the plain versions that ``vct::in_stats`` and
``vct::in_apply`` dispatch to on CPU tensors, the apply's moments (the pair
``_InActSpatial`` keeps for its backward), the operator's fake, and the
wrappers' refusal of tensors off the card (they launch the kernel or raise;
the kernels themselves run in tests/test_torch_kernels.py on the card)."""

import numpy as np
import pytest
import torch

from vae_cyclegan_tpu_torch.kernels import ops as kernel_ops
from vae_cyclegan_tpu_torch.ops import instance_norm as inn
from vae_cyclegan_tpu_torch.parallel import spatial

CASES = [((2, 3, 4, 6), "relu", "act_norm", torch.float32),
         ((2, 5, 8, 8), "leaky_relu", "norm_act", torch.float32),
         ((1, 4, 3, 5), "tanh", "act_norm", torch.bfloat16),
         ((3, 2, 8, 16), "identity", "act_norm", torch.bfloat16)]


def _x(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        (rng.randn(*shape) * 2 + 0.5).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("shape,act,order,dtype", CASES)
def test_plain_apply_moments_equal_plane_moments(shape, act, order, dtype):
    """The apply's CPU version (the operator's dispatch on a CPU tensor)
    returns y and, as (2, N, C, 1, 1) f32, the moments of ``plane_moments``
    from the same sums, bit for bit; with a spatial group of 3's count."""
    x = _x(shape, dtype)
    st = kernel_ops.in_stats(x, act, order)
    assert torch.equal(st, inn.in_stats_reference(x, act, order))
    count = 3.0 * shape[2] * shape[3]
    y, moments = kernel_ops.in_apply(x, st, count, act, order, inn.EPS)
    mu, r = inn.plane_moments(st, count, inn.EPS)
    assert moments.shape == (2, *shape[:2], 1, 1)
    assert moments.dtype == torch.float32
    assert torch.equal(moments[0], mu) and torch.equal(moments[1], r)
    h = x.float()
    if order == "act_norm":
        h = inn.ACTS[act](h)
    want = (h - mu) * r
    if order == "norm_act":
        want = inn.ACTS[act](want)
    assert y.dtype == dtype and torch.equal(y, want.to(dtype))


def test_in_apply_fake_matches_the_cpu_outputs():
    """The operator's fake (what torch.export records) gives the CPU
    version's shapes and dtypes for both outputs."""
    x = _x((2, 3, 4, 6), torch.bfloat16)
    st = inn.in_stats_reference(x, "relu", "norm_act")
    got = kernel_ops.in_apply(x.to("meta"), st.to("meta"), 48.0, "relu",
                              "norm_act", inn.EPS)
    want = kernel_ops.in_apply(x, st, 48.0, "relu", "norm_act", inn.EPS)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                 for t in want]


@pytest.mark.parametrize("kernel", [True, False])
def test_spatial_forward_takes_the_apply_moments(kernel):
    """``_spatial_forward`` at a group of 1 returns the apply's y and
    moments (the operator's, or the plain versions'): y is
    ``tiled_reference`` and the moments ``plane_moments`` of the sums."""
    x = _x((2, 4, 8, 8), torch.float32, 1)
    y, mu, r = inn._spatial_forward(x, "relu", "act_norm", inn.EPS, kernel,
                                    spatial.single())
    want_mu, want_r = inn.plane_moments(
        inn.in_stats_reference(x, "relu", "act_norm"), 64.0, inn.EPS)
    assert torch.equal(y, inn.tiled_reference(x, "relu", "act_norm"))
    assert torch.equal(mu, want_mu) and torch.equal(r, want_r)


def test_split_wrappers_refuse_tensors_off_the_card():
    """The wrappers launch the kernel or raise: a CPU tensor is refused, not
    sent to the plain version."""
    x = _x((2, 3, 4, 6), torch.float32)
    st = inn.in_stats_reference(x, "relu", "act_norm")
    with pytest.raises(ValueError, match="CUDA"):
        inn.in_stats_cuda(x, "relu", "act_norm")
    with pytest.raises(ValueError, match="CUDA"):
        inn.in_apply_cuda(x, st, 24.0, "relu", "act_norm")
