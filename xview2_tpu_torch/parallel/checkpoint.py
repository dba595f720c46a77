"""Checkpoints: ``meta.json`` plus the variables as ``state.npz``.

``meta.json`` is the JAX package's (config, epoch, best_f1, best_epoch).  In
place of orbax's ``tree/`` the variables are one ``state.npz`` keyed by flax
paths (``params/unet/enc_l1/conv1/kernel``, ``batch_stats/...``), so a JAX
checkpoint converts with numpy alone and ``weights.py`` maps the trees onto
the torch modules.  A training checkpoint also holds the optimizer state
(``opt_state/<parameter name>/<buffer>``, e.g. ``exp_avg``) and the step
count (``train/step``), so a resumed run repeats an unbroken one; optimizer
state is the port's own and is not carried across packages.  Checkpoints
without them (eval-only, converted from JAX) load as before.  Under ``--gpus
N`` rank 0 alone writes (:func:`save_on_main`) and every rank restores.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from xview2_tpu_torch.config import Config
from xview2_tpu_torch.parallel import mesh
from xview2_tpu_torch.weights import flatten_tree

_STATE = "state.npz"


def save_checkpoint(path: str, params: dict, batch_stats: dict, *, epoch: int,
                    best_f1: float, best_epoch: int, cfg: Config,
                    opt_state: Optional[dict] = None, step: Optional[int] = None) -> None:
    """Write ``state.npz`` from nested dicts of numpy arrays (flax trees;
    ``opt_state`` as ``{parameter name: {buffer: array}}``) and ``meta.json``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    trees = [("params", params), ("batch_stats", batch_stats)]
    if opt_state is not None:
        trees.append(("opt_state", opt_state))
    if step is not None:
        trees.append(("train", {"step": np.asarray(step, np.int64)}))
    arrays = {"/".join(path): np.asarray(leaf)
              for top, tree in trees for path, leaf in flatten_tree(tree, (top,))}
    tmp = os.path.join(path, f".{_STATE}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, _STATE))
    meta = {"epoch": epoch, "best_f1": float(best_f1), "best_epoch": int(best_epoch),
            "config": json.loads(cfg.to_json())}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def save_on_main(path: str, arrays, **meta) -> None:
    """:func:`save_checkpoint` on rank 0 alone, then a barrier, so every
    rank finds the checkpoint; ``arrays()`` gives ``(params, batch_stats,
    opt_state)`` and runs on rank 0 only (the copies to the host)."""
    def write():
        params, batch_stats, opt_state = arrays()
        save_checkpoint(path, params, batch_stats, opt_state=opt_state, **meta)

    mesh.run_on_main(write)


def load_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(os.path.abspath(path), "meta.json")) as f:
        return json.load(f)


def load_config(path: str) -> Config:
    return Config(**load_metadata(path)["config"])


def restore_raw(path: str) -> Tuple[Dict[str, dict], Dict[str, Any]]:
    """``({"params": tree, "batch_stats": tree, ...}, metadata)`` with
    nested dicts of numpy arrays; a training checkpoint also has
    ``opt_state`` and ``train``."""
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


def optimizer_arrays(model, opt) -> dict:
    """The optimizer's per-parameter state as ``{parameter name: {buffer:
    numpy array}}`` (hyperparameters are rebuilt from the config)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: {k: v.detach().cpu().numpy() for k, v in st.items()}
            for p, st in opt.state.items()}


def load_optimizer_arrays(model, opt, arrays: dict) -> None:
    """Inverse of :func:`optimizer_arrays`: fill ``opt.state`` in place, each
    buffer on its parameter's device (step counters stay where the optimizer
    keeps them, on the CPU)."""
    import torch

    params = dict(model.named_parameters())
    for name, bufs in arrays.items():
        p = params[name]
        opt.state[p] = {
            k: torch.from_numpy(np.array(v)).to(p.device if np.ndim(v) else "cpu")
            for k, v in bufs.items()}
