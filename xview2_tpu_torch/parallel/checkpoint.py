"""Checkpoints: ``meta.json`` plus the variables as ``state.npz``.

``meta.json`` is the JAX package's (config, epoch, best_f1, best_epoch).  In
place of orbax's ``tree/`` the variables are one ``state.npz`` keyed by flax
paths (``params/unet/enc_l1/conv1/kernel``, ``batch_stats/...``), so a JAX
checkpoint converts with numpy alone and ``weights.py`` maps the trees onto
the torch modules.  Optimizer state and step counters belong to the train
slice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from xview2_tpu_torch.config import Config
from xview2_tpu_torch.weights import flatten_tree

_STATE = "state.npz"


def save_checkpoint(path: str, params: dict, batch_stats: dict, *, epoch: int,
                    best_f1: float, best_epoch: int, cfg: Config) -> None:
    """Write ``state.npz`` from nested dicts of numpy arrays (flax trees)
    and ``meta.json``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    arrays = {"/".join(path): np.asarray(leaf)
              for top, tree in (("params", params), ("batch_stats", batch_stats))
              for path, leaf in flatten_tree(tree, (top,))}
    tmp = os.path.join(path, f".{_STATE}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, _STATE))
    meta = {"epoch": epoch, "best_f1": float(best_f1), "best_epoch": int(best_epoch),
            "config": json.loads(cfg.to_json())}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(os.path.abspath(path), "meta.json")) as f:
        return json.load(f)


def load_config(path: str) -> Config:
    return Config(**load_metadata(path)["config"])


def restore_raw(path: str) -> Tuple[Dict[str, dict], Dict[str, Any]]:
    """``({"params": tree, "batch_stats": tree}, metadata)`` with nested
    dicts of numpy arrays."""
    payload: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    with np.load(os.path.join(os.path.abspath(path), _STATE)) as z:
        for key in z.files:
            top, *mods, leaf = key.split("/")
            node = payload.setdefault(top, {})
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
    return payload, load_metadata(path)


def checkpoint_exists(path: Optional[str]) -> bool:
    return bool(path) and os.path.exists(os.path.join(os.path.abspath(path), "meta.json"))
