"""Mapping between a flax variable tree and the port's torch ``state_dict``.

The port's modules carry the flax module paths as their names, so the
mapping is mechanical, leaf by leaf:

* ``params/.../kernel`` (4-D) <-> ``....weight``: conv HWIO <-> OIHW, and the
  transposed-conv kernel ``(kh, kw, out, in)`` <-> torch's ``(in, out, kh,
  kw)`` (no flip).  Both are the same axis permutation ``(3, 2, 0, 1)``.
* ``params/.../scale`` <-> ``....weight`` (1-D, BatchNorm);
  ``params/.../bias`` <-> ``....bias``; the CORAL head's
  ``params/.../coral_bias`` <-> ``....coral_bias``.
* ``batch_stats/.../mean`` <-> ``....running_mean``; ``var`` <->
  ``running_var``.

Both directions work on nested dicts of numpy arrays, as ``jax.device_get``
gives them; ``from_flax`` returns torch tensors ready for
``load_state_dict``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch

_KERNEL_PERM = (3, 2, 0, 1)      # HWIO -> OIHW, (kh, kw, out, in) -> (in, out, kh, kw)
_KERNEL_PERM_INV = (2, 3, 1, 0)

_PARAM_LEAF = {"scale": "weight", "bias": "bias", "coral_bias": "coral_bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def flatten_tree(tree, prefix=()):
    """``(path tuple, leaf)`` pairs of a nested dict, depth first."""
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from flatten_tree(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _insert(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def from_flax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """Flax ``(params, batch_stats)`` -> torch ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in flatten_tree(params):
        arr = np.asarray(leaf)
        if path[-1] == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"kernel {'/'.join(path)} is not 4-D: {arr.shape}")
            name, arr = "weight", np.transpose(arr, _KERNEL_PERM)
        elif path[-1] in _PARAM_LEAF:
            name = _PARAM_LEAF[path[-1]]
        else:
            raise ValueError(f"unknown param leaf {'/'.join(path)}")
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(arr))
    for path, leaf in flatten_tree(batch_stats):
        if path[-1] not in _STAT_LEAF:
            raise ValueError(f"unknown batch_stats leaf {'/'.join(path)}")
        key = ".".join(path[:-1] + (_STAT_LEAF[path[-1]],))
        sd[key] = torch.from_numpy(np.array(leaf))
    return sd


def to_flax(state_dict) -> Tuple[dict, dict]:
    """Torch ``state_dict`` -> flax ``(params, batch_stats)`` of numpy arrays."""
    params: dict = {}
    batch_stats: dict = {}
    inv_param = {v: k for k, v in _PARAM_LEAF.items()}
    inv_stat = {v: k for k, v in _STAT_LEAF.items()}
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        *mods, leaf = key.split(".")
        if leaf in inv_stat:
            _insert(batch_stats, tuple(mods) + (inv_stat[leaf],), arr)
        elif leaf == "weight" and arr.ndim == 4:
            _insert(params, tuple(mods) + ("kernel",),
                    np.ascontiguousarray(np.transpose(arr, _KERNEL_PERM_INV)))
        elif leaf in inv_param:
            _insert(params, tuple(mods) + (inv_param[leaf],), arr)
        else:
            raise ValueError(f"unknown state_dict entry {key!r}")
    return params, batch_stats
