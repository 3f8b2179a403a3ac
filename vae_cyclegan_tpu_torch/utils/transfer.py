"""Transfer-learning weight surgery on state_dict keys.

Counterpart of ``vae_cyclegan_tpu/utils/transfer.py`` (reference
utils.py:57-239): a DoubleAE/DoubleVAE pretraining state_dict initializes
the G/F generators of a Cycle task.

  DoubleAENet {encoder, decoder_A, decoder_B}
    -> G = {encoder, decoder: decoder_B}   (A->B uses the target decoder)
    -> F = {encoder, decoder: decoder_A}   (B->A uses the source decoder)

  DoubleVAENet {encoder, vae_encoder_block_{A,B}, vae_decoder_block_{A,B},
                decoder_{A,B}}
    -> G = {encoder, variational_encoder_block: ..._B,
            variational_decoder_block: ..._B, decoder: decoder_B}
    -> F = the same with the A components.

Each subtree is copied into the task's own parameters
(``load_state_dict``), so G and F hold separate copies of the shared
encoder and share no storage. The discriminators and the optimizers' states
stay as they are. The sanity checks of the reference (G must hold the B
components, F the A components) are kept.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch

#: (G/F module, the DoubleAE subtree G takes, the one F takes)
_DOUBLE_AE = (("encoder", "encoder", "encoder"),
              ("decoder", "decoder_B", "decoder_A"))
_DOUBLE_VAE = (("encoder", "encoder", "encoder"),
               ("variational_encoder_block", "vae_encoder_block_B",
                "vae_encoder_block_A"),
               ("variational_decoder_block", "vae_decoder_block_B",
                "vae_decoder_block_A"),
               ("decoder", "decoder_B", "decoder_A"))
#: the subtrees a source must hold, in the JAX package's order
_NEEDED_AE = ("encoder", "decoder_A", "decoder_B")
_NEEDED_VAE = ("encoder", "vae_encoder_block_A", "vae_encoder_block_B",
               "vae_decoder_block_A", "vae_decoder_block_B", "decoder_A",
               "decoder_B")
#: the reference's sanity checks: (network, module, the subtree it must hold)
_CHECKS_AE = (("G", "decoder", "decoder_B"), ("F", "decoder", "decoder_A"))
_CHECKS_VAE = _CHECKS_AE + (
    ("G", "variational_decoder_block", "vae_decoder_block_B"),
    ("F", "variational_decoder_block", "vae_decoder_block_A"))


def _subtree(sd: Mapping[str, torch.Tensor], name: str
             ) -> Dict[str, torch.Tensor]:
    prefix = f"{name}."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _assert_equal_subtree(module: torch.nn.Module,
                          sub: Mapping[str, torch.Tensor], what: str) -> None:
    own = module.state_dict()
    for k, v in sub.items():
        if not torch.equal(own[k].cpu(), v.cpu()):
            raise AssertionError(f"{what} mismatch — G and F may be swapped!")


def _transfer(task, sd: Mapping[str, torch.Tensor],
              table: Sequence[Tuple[str, str, str]],
              needed: Sequence[str], checks: Sequence[Tuple[str, str, str]],
              source: str) -> None:
    subtrees = {}
    for name in needed:
        subtrees[name] = _subtree(sd, name)
        if not subtrees[name]:
            raise KeyError(f"{source} checkpoint missing '{name}' subtree")
    G, F = task.nets["G"], task.nets["F"]
    for target, b, a in table:
        getattr(G, target).load_state_dict(subtrees[b])
        getattr(F, target).load_state_dict(subtrees[a])
    for net, target, name in checks:
        _assert_equal_subtree(getattr(task.nets[net], target), subtrees[name],
                              f"{net}.{target}")


def load_pretrained_doubleae_to_cycle(task, doubleae_sd: Mapping[str,
                                                                 torch.Tensor]
                                      ) -> None:
    """DoubleAE {encoder, decoder_A, decoder_B} -> the G/F of a Cycle task
    whose generators are autoencoders (CycleAE, CycleAEGAN), in place.
    `doubleae_sd` is a DoubleAE task's state_dict."""
    _transfer(task, doubleae_sd, _DOUBLE_AE, _NEEDED_AE, _CHECKS_AE,
              "DoubleAE")


def load_pretrained_doublevae_to_cycle(task, doublevae_sd: Mapping[
        str, torch.Tensor]) -> None:
    """DoubleVAE components -> the G/F of CycleVAE / CycleVAEGAN, in
    place. `doublevae_sd` is a DoubleVAE task's state_dict."""
    _transfer(task, doublevae_sd, _DOUBLE_VAE, _NEEDED_VAE, _CHECKS_VAE,
              "DoubleVAE")
