"""Data parallelism over a torch.distributed process group.

The exports of ``vae_cyclegan_tpu/parallel/__init__.py`` that have a
counterpart here: ``dp_group`` (JAX's ``dp_axis``), ``dp_normal``,
``dp_scope``, ``sync``; ``make_group`` (``make_mesh``) and
``shard_batch``. Parameters are replicated by construction (every rank
builds them from one seed), so ``replicate_state`` and the shardings have
none; ``eps_queue`` has none (the port's steps take noise as arguments),
and ``spatial_size`` waits for spatial parallelism (ROADMAP.md queue 1,
item 7c).
"""

from vae_cyclegan_tpu_torch.parallel.dp import (
    dp_group,
    dp_normal,
    dp_scope,
    gather,
    sync,
)
from vae_cyclegan_tpu_torch.parallel.mesh import (
    init_from_env,
    is_primary,
    make_group,
    rank,
    resolve_devices,
    shard_batch,
    shard_rows,
    spawn,
    world_size,
)
