"""Spectral normalization by one power iteration per training call
(counterpart of ``vae_cyclegan_tpu/ops/spectral_norm.py``).

The reference wraps the discriminator's final conv in
``torch.nn.utils.spectral_norm``. Here the power-iteration vectors are
explicit tensors that the caller threads from call to call:

  * training call: v <- normalize(W^T u); u <- normalize(W v), both without
    gradient; sigma = u . (W v), differentiable in W; returns W / sigma;
  * evaluation call: no update; sigma from the stored u, v.

W is the OIHW weight flattened to (cout, cin * kh * kw), so v runs over
(I, kH, kW) as in torch (the JAX package flattens over (kH, kW, I); sigma
does not depend on the order).
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-12


def _l2_normalize(t: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    return t / (torch.linalg.vector_norm(t) + eps)


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       update: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (w / sigma in w's dtype, new u, new v); u (cout,) and v
    (cin * kh * kw,) come back as fresh tensors in their own dtypes, never
    as the inputs modified in place (an earlier call's graph may hold
    them)."""
    w_mat = w.reshape(w.shape[0], -1).float()
    uf, vf = u.float(), v.float()
    if update:
        with torch.no_grad():
            vf = _l2_normalize(w_mat.t() @ uf)
            uf = _l2_normalize(w_mat @ vf)
    sigma = uf @ (w_mat @ vf)
    w_sn = (w.float() / sigma).to(w.dtype)
    return w_sn, uf.to(u.dtype), vf.to(v.dtype)
