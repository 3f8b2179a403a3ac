"""NaN/Inf diagnostic dumps.

The reference's NaN guard prints every parameter and gradient to the console
when a non-finite loss appears, then skips the optimizer step (reference
Networks.py:356-372). Counterpart of ``vae_cyclegan_tpu/utils/nan_dump.py``:
when enabled, the skip branch of the task's finite-loss gate
(``Task._finite_update``) writes the offending loss, batch, parameters and
gradients as an .npz into the configured run directory. The gate already
reads the loss's finiteness on the host, so the dump is written from there;
a finite step pays nothing, and while dumping is disabled the task passes
the gate no dump at all.

Keys of a dump: ``loss``; ``batch.<key>`` for each batch array;
``params.<name>`` and ``grads.<name>`` for each parameter the skipped
optimizer covers, under its ``state_dict`` name.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

_lock = threading.Lock()
_dump_dir: Optional[Path] = None
_max_dumps = 3
_dump_count = 0


def enable(run_dir, max_dumps: int = 3) -> None:
    """Route NaN dumps to `run_dir`/nan_dumps, at most `max_dumps` of
    them."""
    global _dump_dir, _max_dumps, _dump_count
    _dump_dir = Path(run_dir) / "nan_dumps"
    _max_dumps = max_dumps
    _dump_count = 0


def disable() -> None:
    global _dump_dir
    _dump_dir = None


def enabled() -> bool:
    return _dump_dir is not None


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value)


def write_dump(loss, batch: Optional[Mapping], params: Mapping,
               grads: Mapping) -> None:
    """Write one dump: `loss`, the `batch` arrays and the named `params`
    and `grads` (tensors or arrays)."""
    global _dump_count
    with _lock:
        if _dump_dir is None or _dump_count >= _max_dumps:
            return
        _dump_count += 1
        n = _dump_count
    os.makedirs(_dump_dir, exist_ok=True)
    payload = {"loss": _numpy(loss)}
    for prefix, tree in (("batch", batch or {}), ("params", params),
                         ("grads", grads)):
        payload.update((f"{prefix}.{k}", _numpy(v)) for k, v in tree.items())
    path = _dump_dir / f"nan_dump_{n:02d}.npz"
    np.savez_compressed(path, **payload)
    print(f"NaN/Inf detected in loss; diagnostic dump written to {path}")
