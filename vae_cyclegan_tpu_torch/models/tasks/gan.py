"""Helpers of the adversarial tasks (counterpart of
``vae_cyclegan_tpu/models/tasks/gan.py``; AEGAN and VAEGAN themselves are
still to port)."""

from __future__ import annotations

import torch

from vae_cyclegan_tpu_torch.models.networks import Discriminator


def d_apply(disc: Discriminator, x: torch.Tensor,
            update: bool) -> torch.Tensor:
    """Apply a discriminator to an NCHW batch, returning its (B,) scores.
    With `update` the call runs one power iteration and advances the
    discriminator's spectral state; the JAX package returns that state as a
    new collection, here the module holds it, so the calls thread it in the
    order they are made."""
    return disc(x, update_stats=update)
