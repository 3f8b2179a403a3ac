"""Frechet Inception Distance (beyond-parity quality metric).

Counterpart of ``vae_cyclegan_tpu/utils/fid.py``. Three pieces:

  * `frechet_distance` — the closed-form 2-Wasserstein distance between
    Gaussians, pure numpy (eigendecomposition matrix sqrt), copied.
  * `InceptionV3` — the torchvision-architecture Inception v3 feature
    trunk (through the global-average pool, 2048-d) as an ``nn.Module``
    whose state_dict keys are torchvision's (``Mixed_5b.branch1x1.conv.
    weight``, ``...bn.running_var``), the layer graph of the JAX package's
    Flax module (the standard pytorch-fid scoring graph).
  * `load_torch_inception` — a torchvision `inception_v3` state_dict
    (``.pth``) or an ``.npz`` with the same keys, loaded into the module;
    the aux-logits and fc heads are skipped. Weights are NOT bundled and
    never fetched: pass any torchvision-format checkpoint, e.g.
    ``inception_v3_google-0cc3c7bd.pth``.

`make_feature_fn` resizes to 299 x 299 as ``jax.image.resize(...,
"bilinear")`` does (half-pixel centres, the triangle kernel widened when
shrinking, each output's weights normalised), in f32 without TF32, then runs
the trunk. The eval driver only needs `fid_from_features` and a feature
function.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Frechet distance (pure numpy)
# ---------------------------------------------------------------------------


def activation_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu, covariance)."""
    f = np.asarray(feats, np.float64)
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    """Matrix square root of a symmetric PSD matrix via eigh."""
    w, v = np.linalg.eigh((a + a.T) / 2.0)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    """||mu1-mu2||^2 + tr(s1 + s2 - 2 (s1 s2)^(1/2)).

    tr((s1 s2)^(1/2)) is computed as tr((s1^(1/2) s2 s1^(1/2))^(1/2)) —
    the inner matrix is symmetric PSD, so eigh is stable (no scipy
    sqrtm of a non-symmetric product).
    """
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2
    r1 = _sqrtm_psd(sigma1)
    inner = r1 @ sigma2 @ r1
    w = np.clip(np.linalg.eigvalsh((inner + inner.T) / 2.0), 0.0, None)
    tr_sqrt = float(np.sqrt(w).sum())
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_sqrt)


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    mu_a, s_a = activation_stats(feats_a)
    mu_b, s_b = activation_stats(feats_b)
    return frechet_distance(mu_a, s_a, mu_b, s_b)


# ---------------------------------------------------------------------------
# Inception v3 feature trunk (torchvision graph and key names)
# ---------------------------------------------------------------------------


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm(eps 1e-3, inference) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avgpool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionV3(nn.Module):
    """Feature trunk: (N, 3, H, W) in [0, 1], H and W at least 75 ->
    (N, 2048) pool features. The input is rescaled to [-1, 1] inside
    (pytorch-fid convention). Evaluation mode throughout (BatchNorm uses
    its running statistics)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.eval()

    def forward(self, x):
        x = x * 2.0 - 1.0
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = _maxpool3s2(self.Conv2d_2b_3x3(x))
        x = self.Conv2d_3b_1x1(x)
        x = _maxpool3s2(self.Conv2d_4a_3x3(x))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# torchvision weight import
# ---------------------------------------------------------------------------


def load_torch_inception(path: str, device="cpu") -> InceptionV3:
    """An InceptionV3 on `device` holding a torchvision `inception_v3`
    state_dict (.pth; keys like `Mixed_5b.branch1x1.conv.weight`) or a
    plain .npz of numpy arrays with the same keys. The aux-logits and fc
    heads are skipped; `num_batches_tracked` may be absent."""
    sd = _load_state_dict(path)
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()
          if not k.startswith(("fc.", "AuxLogits."))}
    model = InceptionV3()
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{path}: missing {missing[:5]}, unexpected "
                       f"{unexpected[:5]}")
    return model.to(device).eval()


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    if str(path).endswith((".npz", ".npy")):
        return dict(np.load(path, allow_pickle=True))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v.numpy() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# end-to-end scoring
# ---------------------------------------------------------------------------

#: JAX's threshold below which a weight column's sum counts as zero
_MIN_SUM = 1000.0 * float(np.finfo(np.float32).eps)


def resize_weights(in_size: int, out_size: int, device="cpu") -> torch.Tensor:
    """(in_size, out_size) f32 weights of ``jax.image.resize(...,
    "bilinear")`` along one axis: JAX's ``compute_weight_mat`` with the
    triangle kernel, scale out / in and no translation."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    dist = torch.abs(sample_f[None, :] - torch.arange(in_size, **f32)[:, None])
    # an elementwise f32 division, as JAX's (torch turns a division by a
    # scalar into a product with its reciprocal)
    dist = dist / torch.full_like(dist, kernel_scale)
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > _MIN_SUM,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@contextlib.contextmanager
def ieee_f32() -> Iterator[None]:
    """f32 convs and products in full f32 (no TF32) on the card."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = prev


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) f32 -> (N, 299, 299, C), as the JAX package's
    ``jax.image.resize(x, (N, 299, 299, C), "bilinear")``."""
    wh = resize_weights(x.shape[1], 299, x.device)
    ww = resize_weights(x.shape[2], 299, x.device)
    rows = torch.einsum("hs,bhwc->bswc", wh, x)
    return torch.einsum("wt,bswc->bstc", ww, rows)


def make_feature_fn(model: InceptionV3) -> Callable:
    """fn: (N, H, W, 3) float in [0, 1] (numpy or torch) -> (N, 2048) f32
    numpy features, computed on the model's device in f32 without TF32."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def feats(x):
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32).to(device)
        with ieee_f32():
            x = resize_299(x).permute(0, 3, 1, 2).contiguous()
            return model(x).cpu().numpy()

    return feats


def fid_score(
    images_a: Sequence[np.ndarray],
    images_b: Sequence[np.ndarray],
    feature_fn: Callable,
    batch_size: int = 8,
) -> float:
    """FID between two image sets ((H,W,3) float arrays in [0,1])."""

    def run(images):
        out = []
        buf = [np.asarray(im, np.float32) for im in images]
        for i in range(0, len(buf), batch_size):
            chunk = np.stack(buf[i : i + batch_size])
            out.append(np.asarray(feature_fn(chunk)))
        return np.concatenate(out, axis=0)

    return fid_from_features(run(images_a), run(images_b))
