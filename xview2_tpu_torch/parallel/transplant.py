"""The localization -> damage encoder transplant of ``--ckpt_pre`` (port of
``xview2_tpu/parallel/transplant.py``, the ``siamese`` case).

The reference (``main.py:76-94``) copies every ``enc``-named tensor of a
localization checkpoint into the damage model.  Here it works on the
port's ``state_dict``: for ``siamese`` every ``unet.enc_l*`` entry of the
localization state (parameters and BatchNorm running statistics alike) is
copied onto the same name, and an entry whose shape differs keeps the
target's value, as the JAX ``_copy_matching`` does.  The other variants
place the encoder elsewhere and are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import torch

log = logging.getLogger(__name__)

ENC_KEYS = ("enc_l1", "enc_l2", "enc_l3", "enc_l4", "enc_l5")


def transplant_encoder(dmg_model: str, model: torch.nn.Module,
                       loc_state: Dict[str, torch.Tensor]) -> List[str]:
    """Copy the localization encoder in ``loc_state`` (a ``UNetLoc``
    ``state_dict``) into ``model`` in place; returns the names copied."""
    if dmg_model != "siamese":
        raise NotImplementedError(f"the --ckpt_pre transplant for --dmg_model {dmg_model} is "
                                  "not ported yet (ROADMAP Queue 1, damage variants)")
    prefixes = tuple(f"unet.{k}." for k in ENC_KEYS)
    copied = []
    with torch.no_grad():
        for name, dst in model.state_dict().items():
            src = loc_state.get(name)
            if not name.startswith(prefixes) or src is None:
                continue
            if tuple(src.shape) != tuple(dst.shape):
                log.warning("transplant: shape mismatch at %s (%s vs %s), keeping target",
                            name, tuple(dst.shape), tuple(src.shape))
                continue
            dst.copy_(src)
            copied.append(name)
    return copied
