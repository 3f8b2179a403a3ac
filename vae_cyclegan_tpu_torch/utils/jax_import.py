"""Carry JAX package weights into the port.

The reverse of ``vae_cyclegan_tpu/utils/torch_import.py``: a Flax ``params``
tree, as nested dicts of numpy arrays, becomes a ``state_dict`` whose keys
are the reference's torch keys (``encoder.model.0.conv.weight``, ...).
Conv kernels go from Flax HWIO to torch OIHW. The trees are plain dicts, so
this module needs no JAX: convert device arrays with ``np.asarray`` first
(``params_from_jax`` does so for anything array-like).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# Flax module path -> torch module path, in the reference's registration order
_ENCODER = {
    "CaSb_0": {"ReflectConv_0": "model.0.conv"},
    "DBlock_0": {"ReflectConv_0": "model.1.conv"},
    "DBlock_1": {"ReflectConv_0": "model.2.conv"},
    "DBlock_2": {"ReflectConv_0": "model.3.conv"},
    "DBlock_3": {"ReflectConv_0": "model.4.conv"},
    "RBlock_0": {"ReflectConv_0": "model.5.conv1",
                 "ReflectConv_1": "model.5.conv2"},
}
_DECODER = {
    "RBlock_0": {"ReflectConv_0": "model.0.conv1",
                 "ReflectConv_1": "model.0.conv2"},
    "UBlock_0": {"ReflectConv_0": "model.1.conv"},
    "UBlock_1": {"ReflectConv_0": "model.2.conv"},
    "UBlock_2": {"ReflectConv_0": "model.3.conv"},
    "UBlock_3": {"ReflectConv_0": "model.4.conv"},
    "CaSb_0": {"ReflectConv_0": "model.5.conv"},
}
_VAR_ENCODER = {
    "LConv_0": {"ReflectConv_0": "muConv.conv"},
    "SConv_0": {"ReflectConv_0": "logvarConv.0.conv"},
    "SConv_1": {"ReflectConv_0": "logvarConv.1.conv"},
}
_VAR_DECODER = {"SConv_0": {"ReflectConv_0": "conv.conv"}}
_VAE = {
    "encoder": _ENCODER,
    "variational_encoder_block": _VAR_ENCODER,
    "variational_decoder_block": _VAR_DECODER,
    "decoder": _DECODER,
}
_AUTOENCODER = {"encoder": _ENCODER, "decoder": _DECODER}


def _walk(tree: Mapping, table: Mapping, prefix: str,
          out: Dict[str, torch.Tensor]) -> None:
    """Map `tree` by `table`, whose leaves are torch module paths (under
    `prefix`) of the Flax ``ReflectConv_i`` nodes they stand for."""
    if set(tree) != set(table):
        raise KeyError(f"{prefix or 'params'}: got modules {sorted(tree)}, "
                       f"expected {sorted(table)}")
    for name, sub in table.items():
        if isinstance(sub, dict):
            _walk(tree[name], sub, prefix, out)
            continue
        conv = tree[name]["Conv_0"]
        kernel = np.asarray(conv["kernel"])
        out[f"{prefix}{sub}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))))
        if "bias" in conv:
            out[f"{prefix}{sub}.bias"] = torch.from_numpy(
                np.array(conv["bias"]))


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """state_dict for the port from a Flax params tree: one generator's tree
    (VariationalAutoencoderNet or AutoencoderNet), or ``{"G": ..., "F":
    ...}`` of two, which get the "G." / "F." prefixes."""
    out: Dict[str, torch.Tensor] = {}
    if set(tree) == {"G", "F"}:
        for key in ("G", "F"):
            for name, value in params_from_jax(tree[key]).items():
                out[f"{key}.{name}"] = value
        return out
    nets = _VAE if "variational_encoder_block" in tree else _AUTOENCODER
    if set(tree) != set(nets):
        raise KeyError(f"params: got networks {sorted(tree)}, expected "
                       f"{sorted(nets)}")
    for net, table in nets.items():
        _walk(tree[net], table, f"{net}.", out)
    return out
