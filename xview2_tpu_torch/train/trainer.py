"""Eval mode (port of ``test``, ``_save_predictions`` and
``_clear_task_artifacts`` of ``xview2_tpu/train/trainer.py``).

``test(cfg)`` restores a checkpoint, runs the holdout split through the eval
step, dumps ``probs/*.npy`` and ``targets/*.png`` in the JAX package's
format (localization probs = sigmoid of channel 1, filenames
``test_localization_{idx:05d}.npy`` and ``..._target.png``) and logs the F1.
Training (``fit``) belongs to the next slice (ROADMAP Queue 1, train step).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch
from PIL import Image

from xview2_tpu_torch.config import Config, apply_precision
from xview2_tpu_torch.data.pipeline import make_test_loader
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.ops.metrics import compute_f1, init_f1_state
from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
from xview2_tpu_torch.parallel.steps import make_eval_step, resolve_device
from xview2_tpu_torch.train.logging import MetricsLogger, test_metrics
from xview2_tpu_torch.weights import from_flax


def _save_predictions(cfg: Config, logits: torch.Tensor, targets: np.ndarray,
                      valid: np.ndarray, start_idx: int) -> int:
    """Write per-image localization prob .npy (sigmoid of channel 1) +
    target .png (reference plt.py:126-144)."""
    probs_dir = os.path.join(cfg.results, "probs")
    targets_dir = os.path.join(cfg.results, "targets")
    os.makedirs(probs_dir, exist_ok=True)
    os.makedirs(targets_dir, exist_ok=True)
    probs = torch.sigmoid(logits[..., 1]).to(torch.float32).cpu().numpy()
    idx = start_idx
    for prob, target, v in zip(probs, targets, valid):
        if v <= 0:
            continue
        fname = os.path.join(probs_dir, f"test_localization_{idx:05d}")
        np.save(fname, prob)
        Image.fromarray(target.astype(np.uint8)).save(
            os.path.join(targets_dir, f"test_localization_{idx:05d}_target.png"))
        idx += 1
    return idx


def _clear_task_artifacts(cfg: Config) -> None:
    """Drop stale eval dumps of the current task before re-dumping (per task,
    so a post eval into the same ``--results`` keeps the pre dumps)."""
    task = "localization" if cfg.type == "pre" else "damage"
    for sub in ("probs", "targets"):
        d = os.path.join(cfg.results, sub)
        os.makedirs(d, exist_ok=True)
        for p in glob.glob(os.path.join(d, f"test_{task}_*")):
            os.unlink(p)


def _check_supported(cfg: Config) -> None:
    if not cfg.fold_eval_bn:
        raise NotImplementedError("--fold_eval_bn 0 is not ported: eval BatchNorm always "
                                  "runs folded (ROADMAP Queue 1, open items)")
    if cfg.gpus != 1 or cfg.spatial_shards != 1:
        raise NotImplementedError("--gpus/--spatial_shards > 1 are not ported yet "
                                  "(ROADMAP Queue 1, multi-GPU)")


def test(cfg: Config, device="cuda") -> dict:
    """Eval mode: restore the checkpoint, run the holdout, dump artifacts and
    metrics (reference main.py:113-122 eval branch).  Runs on ``device``,
    CUDA by default."""
    dev = resolve_device(device)
    if not ckpt_lib.checkpoint_exists(cfg.ckpt):
        raise FileNotFoundError(f"no checkpoint found for evaluation at {cfg.ckpt!r}")
    # model hyperparameters come from the checkpoint; TTA and the fused tail
    # are eval-time compute knobs (identical variable trees), overridable
    saved = ckpt_lib.load_config(cfg.ckpt)
    tta = {"auto": saved.tta, "on": True, "off": False}[cfg.eval_tta]
    fused = {"auto": saved.fused_tail, "on": True, "off": False}[cfg.eval_fused_tail]
    einsum = {"auto": saved.einsum_1x1, "on": True, "off": False}[cfg.eval_einsum_1x1]
    cfg = saved.replace(exec_mode="eval", data=cfg.data, results=cfg.results,
                        gpus=cfg.gpus, num_workers=cfg.num_workers,
                        val_batch_size=cfg.val_batch_size, logname=cfg.logname,
                        ckpt=cfg.ckpt, tta=tta, fold_eval_bn=cfg.fold_eval_bn,
                        fused_tail=fused, einsum_1x1=einsum)
    _check_supported(cfg)
    apply_precision(cfg)
    model = build_model(cfg)
    payload, _ = ckpt_lib.restore_raw(cfg.ckpt)
    model.load_state_dict(from_flax(payload["params"], payload["batch_stats"]), strict=True)
    model.to(dev)

    _clear_task_artifacts(cfg)
    loader = make_test_loader(cfg)
    eval_step = make_eval_step(cfg, model, device=dev)
    f1_state = init_f1_state(cfg.n_metric_class, device=dev)
    idx = 0
    for batch in loader:
        f1_state, _, logits = eval_step(f1_state, batch.image, batch.mask, batch.valid)
        idx = _save_predictions(cfg, logits, batch.mask, batch.valid, idx)
    f1, per_class = compute_f1(f1_state, cfg.n_metric_class)
    logger = MetricsLogger(cfg.results, cfg.logname)
    data = test_metrics(f1, per_class)
    logger.log((), data)
    logger.close()
    return data
