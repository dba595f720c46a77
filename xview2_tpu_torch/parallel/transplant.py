"""The localization -> damage encoder transplant of ``--ckpt_pre`` (port of
``xview2_tpu/parallel/transplant.py``).

The reference (``main.py:76-94``) copies every ``enc``-named tensor of a
localization checkpoint into the damage model.  Here it works on the
port's ``state_dict``: every ``unet.enc_l*`` entry of the localization state
(parameters and BatchNorm running statistics alike) is copied to where the
variant keeps its encoder, as the JAX ``transplant_collection`` places it:

* ``siamese``: ``unet.enc_l*``; ``siameseEnc``: the top-level ``enc_l*``;
* ``parallel``: both ``unet_pre.enc_l*`` and ``unet_post.enc_l*``;
* ``parallelEnc``: ``enc_pre_i`` and ``enc_post_i`` for ``enc_l{i+1}``;
* ``fused``/``fusedEnc``: ``enc_fusion_i.pre_layer`` and ``.post_layer``;
* ``diff``/``cat``: ``unet.unet.enc_l*``.

An entry whose shape differs (``cat``'s 6-channel stem) keeps the target's
value, with a warning, as the JAX ``_copy_matching`` does.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import torch

log = logging.getLogger(__name__)

ENC_KEYS = ("enc_l1", "enc_l2", "enc_l3", "enc_l4", "enc_l5")


def placements(dmg_model: str) -> List[Tuple[str, str]]:
    """``(destination prefix, localization prefix)`` pairs of ``dmg_model``'s
    encoder, one per stage and branch."""
    pairs = []
    for i, k in enumerate(ENC_KEYS):
        dst = {"siamese": [f"unet.{k}."],
               "siameseEnc": [f"{k}."],
               "parallel": [f"unet_pre.{k}.", f"unet_post.{k}."],
               "parallelEnc": [f"enc_pre_{i}.", f"enc_post_{i}."],
               "fused": [f"enc_fusion_{i}.pre_layer.", f"enc_fusion_{i}.post_layer."],
               "fusedEnc": [f"enc_fusion_{i}.pre_layer.", f"enc_fusion_{i}.post_layer."],
               "diff": [f"unet.unet.{k}."],
               "cat": [f"unet.unet.{k}."]}
        if dmg_model not in dst:
            raise ValueError(f"unknown dmg_model {dmg_model!r}")
        pairs += [(d, f"unet.{k}.") for d in dst[dmg_model]]
    return pairs


def transplant_encoder(dmg_model: str, model: torch.nn.Module,
                       loc_state: Dict[str, torch.Tensor]) -> List[str]:
    """Copy the localization encoder in ``loc_state`` (a ``UNetLoc``
    ``state_dict``) into ``model`` in place; returns the names copied."""
    pairs = placements(dmg_model)
    copied = []
    with torch.no_grad():
        for name, dst in model.state_dict().items():
            src_name = next((src + name[len(d):] for d, src in pairs if name.startswith(d)),
                            None)
            src = None if src_name is None else loc_state.get(src_name)
            if src is None:
                continue
            if tuple(src.shape) != tuple(dst.shape):
                log.warning("transplant: shape mismatch at %s (%s vs %s), keeping target",
                            name, tuple(dst.shape), tuple(src.shape))
                continue
            dst.copy_(src)
            copied.append(name)
    return copied
