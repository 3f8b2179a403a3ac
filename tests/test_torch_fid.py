"""The port's FID (vae_cyclegan_tpu_torch/utils/fid.py) against the JAX
package's utils/fid.py.

* The Frechet math: the cases of tests/test_fid.py, and the port's
  ``frechet_distance`` / ``fid_from_features`` equal to JAX's within 1e-9 on
  seeded features; ``fid_score``'s batching with a stub extractor.
* The resize to 299: the port's weight matrices bit for bit JAX's, and the
  resized images against ``jax.image.resize(..., "bilinear")`` when growing
  and when shrinking.
* ``InceptionV3``: the same seeded torchvision-layout weights (an .npz)
  loaded on both sides by each ``load_torch_inception``; the features at
  the smallest input the trunk takes (75 x 75) within 1e-4 of the largest
  feature per element (measured: see ``FEATURE_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_cyclegan_tpu.utils import fid as jax_fid
from vae_cyclegan_tpu_torch.utils import fid

# features of the two trunks on the same weights and input: f32 convs on
# two backends; measured at most 1.2e-6 of the largest feature
FEATURE_TOL = 1e-4


def test_frechet_identical_is_zero():
    rng = np.random.RandomState(0)
    f = rng.randn(64, 8)
    mu, s = fid.activation_stats(f)
    assert fid.frechet_distance(mu, s, mu, s) == pytest.approx(0.0, abs=1e-8)


def test_frechet_diagonal_closed_form():
    mu1, mu2 = np.array([0.0, 0.0]), np.array([3.0, 4.0])
    s1, s2 = np.diag([1.0, 4.0]), np.diag([9.0, 1.0])
    want = 25.0 + (1 - 3) ** 2 + (2 - 1) ** 2
    assert fid.frechet_distance(mu1, s1, mu2, s2) == pytest.approx(
        want, rel=1e-9)


@pytest.mark.parametrize("n,d,shift", [(40, 6, 0.5), (50, 16, 0.0),
                                       (12, 30, 2.0)])
def test_frechet_matches_jax(n, d, shift):
    rng = np.random.RandomState(n + d)
    a, b = rng.randn(n, d), rng.randn(n + 7, d) * 1.3 + shift
    got = fid.fid_from_features(a, b)
    assert got == pytest.approx(jax_fid.fid_from_features(a, b), abs=1e-9,
                                rel=1e-9)
    assert got == pytest.approx(fid.fid_from_features(b, a), rel=1e-6)


def test_fid_score_with_stub_extractor():
    rng = np.random.RandomState(2)
    imgs_a = [rng.rand(8, 8, 3).astype(np.float32) for _ in range(12)]
    imgs_b = [rng.rand(8, 8, 3).astype(np.float32) + 0.3 for _ in range(12)]

    def feature_fn(batch):
        b = np.asarray(batch)
        return b.reshape(b.shape[0], -1)[:, :10]

    same = fid.fid_score(imgs_a, imgs_a, feature_fn, batch_size=5)
    diff = fid.fid_score(imgs_a, imgs_b, feature_fn, batch_size=5)
    assert same == pytest.approx(0.0, abs=1e-6)
    assert diff > same
    assert diff == pytest.approx(
        jax_fid.fid_score(imgs_a, imgs_b, feature_fn, batch_size=5),
        abs=1e-9)


@pytest.mark.parametrize("n,atol", [(64, 0.0), (301, 0.0), (320, 0.0),
                                    (600, 1.2e-7)])
def test_resize_weights_are_jax_weights(n, atol):
    """JAX's compute_weight_mat (triangle kernel, antialiased) as
    jax.image.resize calls it: bit for bit at 64, 301 and 320; at 600 the
    kernel spans about four inputs and each output's weight sum is added in
    another order than XLA's, measured 1 ulp (6e-8) apart."""
    from jax._src.image import scale as jax_scale

    want = np.asarray(jax_scale.compute_weight_mat(
        n, 299, 299 / n, 0.0, jax_scale._kernels[jax_scale.ResizeMethod.LINEAR],
        True))
    got = fid.resize_weights(n, 299).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("h,w", [(64, 48), (320, 301), (299, 299)])
def test_resize_matches_jax(h, w):
    """The resized images: within 5e-5 of JAX's (its CPU einsum is up to
    1.2e-5 off the f64 product of the same weights at 320 x 301, the port's
    1.1e-7) and within 1e-6 of the f64 product."""
    x = np.random.RandomState(h).rand(2, h, w, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       method="bilinear"))
    got = fid.resize_299(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    rows = np.einsum("bhwc,hs->bswc", x.astype(np.float64),
                     fid.resize_weights(h, 299).double().numpy())
    exact = np.einsum("bswc,wt->bstc", rows,
                      fid.resize_weights(w, 299).double().numpy())
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)


def _seeded_weights(path):
    """A torchvision-layout inception_v3 state_dict from a seed: He-scaled
    conv weights, BatchNorm near identity, written as an .npz."""
    rng = np.random.RandomState(0)
    sd = {}
    for k, v in fid.InceptionV3().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            fan_in = int(np.prod(shape[1:]))
            a = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif k.endswith("bn.weight"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif k.endswith(("bn.bias", "running_mean")):
            a = 0.1 * rng.randn(*shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:  # num_batches_tracked: torchvision's, absent from an .npz
            continue
        sd[k] = a.astype(np.float32)
    sd["fc.weight"] = np.zeros((2, 2048), np.float32)  # skipped on load
    np.savez(path, **sd)


def test_inception_features_match_jax(tmp_path):
    path = tmp_path / "inception.npz"
    _seeded_weights(path)
    x = np.random.RandomState(1).rand(2, 75, 75, 3).astype(np.float32)
    want = np.asarray(jax.jit(jax_fid.InceptionV3().apply)(
        jax_fid.load_torch_inception(str(path)), jnp.asarray(x)))
    model = fid.load_torch_inception(str(path))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= FEATURE_TOL * np.abs(want).max()


def test_load_torch_inception_checks_keys(tmp_path):
    path = tmp_path / "partial.npz"
    np.savez(path, **{"Conv2d_1a_3x3.conv.weight":
                      np.zeros((32, 3, 3, 3), np.float32)})
    with pytest.raises(KeyError, match="missing"):
        fid.load_torch_inception(str(path))
