"""Pretrained encoder weights for ``--pretrained_enc`` (port of
``xview2_tpu/models/pretrained.py``).

Reads the flat ``.npz`` that ``models/convert_weights.py`` (or the JAX
package's ``tools/convert_weights.py``) writes from a torchvision/ResNeSt
``.pth``: ``params/enc_l1/conv1/kernel``, ``batch_stats/enc_l2/...``.  The
trees go through ``weights.from_flax`` as a ``UNetLoc``'s ``unet.enc_l*``
and are grafted where the model keeps its encoder by the ``--ckpt_pre``
transplant (``parallel/transplant.py``), as the JAX trainer does
(``trainer.py:168-181``): variant ``siamese`` (the ``unet.enc_l*`` place,
which is also ``UNetLoc``'s) for ``--type pre``, ``cfg.dmg_model``
otherwise.  Tensors whose shapes differ, such as the ``cat`` variant's
6-channel stem, keep their initial values.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from xview2_tpu_torch.parallel.transplant import transplant_encoder
from xview2_tpu_torch.weights import from_flax


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        *parts, leaf = key.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_encoder_npz(path: str) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)`` trees with ``enc_l1..enc_l5`` roots."""
    with np.load(path) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    return tree.get("params", {}), tree.get("batch_stats", {})


def encoder_state(path: str) -> Dict[str, torch.Tensor]:
    """The ``.npz`` as a ``UNetLoc`` ``state_dict`` fragment
    (``unet.enc_l*...``)."""
    params, stats = load_encoder_npz(path)
    return from_flax({"unet": params}, {"unet": stats})


def apply_pretrained_encoder(model: torch.nn.Module, path: str, variant: str) -> List[str]:
    """Graft the encoder of ``path`` into ``model`` in place (``variant``:
    ``"siamese"`` for a localization model, else the damage variant);
    returns the names of the tensors copied."""
    return transplant_encoder(variant, model, encoder_state(path))
