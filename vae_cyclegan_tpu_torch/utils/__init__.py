"""Checkpointing, weight transfer, preemption, NaN dumps, TensorBoard,
metrics, FID, and the weight bridge from the JAX package (``jax_import``).

The same exports as ``vae_cyclegan_tpu/utils/__init__.py``; ``fid``,
``metrics``, ``nan_dump`` and ``tb`` are imported by their callers."""

from vae_cyclegan_tpu_torch.utils.checkpoint import (
    save_checkpoint,
    load_checkpoint,
    checkpoint_exists,
)
from vae_cyclegan_tpu_torch.utils.transfer import (
    load_pretrained_doubleae_to_cycle,
    load_pretrained_doublevae_to_cycle,
)
from vae_cyclegan_tpu_torch.utils.preempt import GracefulShutdown
