"""Host-side data pipeline: dataset formats, synchronized augmentation,
batched prefetching loader, decoded-image cache, and the on-device
augmentation of the raw wire format (``device_aug``).

Counterpart of ``vae_cyclegan_tpu/data/``, with the same exports; it
imports neither JAX nor the JAX package, and Pillow only where a path
needs it."""

from vae_cyclegan_tpu_torch.data.transforms import (
    AugmentConfig,
    ColorJitterConfig,
)
from vae_cyclegan_tpu_torch.data.datasets import (
    HypersimDataset,
    SatelliteMapDataset,
    Summer2WinterDataset,
    Subset,
    split_dataset,
)
from vae_cyclegan_tpu_torch.data.loader import DataLoader
from vae_cyclegan_tpu_torch.data.cache import DecodedImageCache
