"""Carry JAX package weights into the port.

The reverse of ``vae_cyclegan_tpu/utils/torch_import.py``: a Flax ``params``
tree (and, for the discriminators, the ``spectral`` collection), as nested
dicts of numpy arrays, becomes a ``state_dict`` whose keys are the
reference's torch keys (``encoder.model.0.conv.weight``, ...,
``model.4.weight_orig``, ``model.4.weight_u``, ``model.4.weight_v``).
Conv kernels go from Flax HWIO to torch OIHW; the spectral v goes from the
JAX package's (kH, kW, I) flattening to torch's (I, kH, kW). The trees are
plain dicts, so this module needs no JAX: convert device arrays with
``np.asarray`` first (``params_from_jax`` does so for anything array-like).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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


_DISCRIMINATOR = {f"CaSb_{i}": {"ReflectConv_0": f"model.{i}.conv"}
                  for i in range(4)}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


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
            out[f"{prefix}{sub}.bias"] = _tensor(conv["bias"])


def discriminator_from_jax(params: Mapping, spectral: Mapping
                           ) -> Dict[str, torch.Tensor]:
    """state_dict of one Discriminator from its Flax params and spectral
    collection (the inverse of ``torch_import.discriminator_params``)."""
    if set(params) != set(_DISCRIMINATOR) | {"SpectralConv_0"}:
        raise KeyError(f"discriminator params: got modules {sorted(params)}")
    out: Dict[str, torch.Tensor] = {}
    _walk({k: v for k, v in params.items() if k != "SpectralConv_0"},
          _DISCRIMINATOR, "", out)
    conv = params["SpectralConv_0"]
    kernel = np.asarray(conv["kernel"])  # (kH, kW, I, O)
    kh, kw, i, _ = kernel.shape
    vec = spectral["SpectralConv_0"]
    out["model.4.bias"] = _tensor(conv["bias"])
    out["model.4.weight_orig"] = torch.from_numpy(
        np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))))
    out["model.4.weight_u"] = _tensor(vec["u"])
    out["model.4.weight_v"] = torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(vec["v"]).reshape(kh, kw, i), (2, 0, 1))
        .reshape(-1)))
    return out


def params_from_jax(tree: Mapping, spectral: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """state_dict for the port from a Flax params tree: one generator's tree
    (VariationalAutoencoderNet or AutoencoderNet); ``{"G": ..., "F": ...}``
    of two, which get the "G." / "F." prefixes; or a cycle-GAN task's
    ``{"G", "F", "DX", "DY"}`` with its ``spectral`` collection ``{"DX":
    ..., "DY": ...}``, the discriminators under "DX." / "DY."."""
    out: Dict[str, torch.Tensor] = {}
    if set(tree) in ({"G", "F"}, {"G", "F", "DX", "DY"}):
        for key in ("G", "F"):
            for name, value in params_from_jax(tree[key]).items():
                out[f"{key}.{name}"] = value
        for key in sorted(set(tree) - {"G", "F"}):
            if spectral is None:
                raise KeyError(f"{key}: the discriminators need the spectral "
                               "collection")
            for name, value in discriminator_from_jax(
                    tree[key], spectral[key]).items():
                out[f"{key}.{name}"] = value
        return out
    nets = _VAE if "variational_encoder_block" in tree else _AUTOENCODER
    if set(tree) != set(nets):
        raise KeyError(f"params: got networks {sorted(tree)}, expected "
                       f"{sorted(nets)}")
    for net, table in nets.items():
        _walk(tree[net], table, f"{net}.", out)
    return out
