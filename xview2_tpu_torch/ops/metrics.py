"""Streaming F1 metric state (port of ``xview2_tpu/ops/metrics.py``).

Per-class tp/fp/fn counters as f32 tensors on the device, updated by the eval
step (reference ``utils/f1.py``): label conversion per head type,
post-task restriction to building pixels, ``f1 = 200*tp/(2tp+fp+fn)`` and
the damage aggregate as a harmonic mean with the 1e-6 guard.  Under a
data-parallel group each batch's increments are summed over the ranks (one
``mesh.global_sum``) before they are added, so the counts accumulate in
JAX's order: batch by batch over the global batch (float32 counts pass
2^24 on a real holdout, so the order matters).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from xview2_tpu_torch.parallel import mesh


class F1State(NamedTuple):
    tp: torch.Tensor  # (n_class - 1,)
    fp: torch.Tensor
    fn: torch.Tensor


def init_f1_state(n_class: int, device="cpu") -> F1State:
    z = torch.zeros((n_class - 1,), dtype=torch.float32, device=device)
    return F1State(tp=z, fp=z.clone(), fn=z.clone())


def convert_to_labels(loss_str: str, logits: torch.Tensor) -> torch.Tensor:
    """Logits -> 1-based damage labels (reference ``f1.py:7-15``)."""
    if loss_str == "mse":
        preds = torch.round(torch.relu(logits[..., 0])) + 1.0
        return torch.clamp(preds, max=4.0).to(torch.int32)
    if loss_str == "coral":
        return torch.sum(torch.sigmoid(logits) > 0.5, dim=-1).to(torch.int32) + 1
    return torch.argmax(logits, dim=-1).to(torch.int32) + 1


def update_f1_state(state: F1State, logits: torch.Tensor, targets: torch.Tensor, *,
                    n_class: int, loss_str: str,
                    sample_valid: Optional[torch.Tensor] = None) -> F1State:
    """Accumulate tp/fp/fn from NHWC logits and (B, H, W) targets;
    ``sample_valid`` (B,) 0/1 keeps padded eval samples out of the counts."""
    targets = targets.to(torch.int32)
    if n_class == 5:
        preds = convert_to_labels(loss_str, logits.to(torch.float32))
        valid = (targets > 0).to(torch.float32)
    else:
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        valid = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    if sample_valid is not None:
        valid = valid * sample_valid.to(torch.float32)[:, None, None]
    tps, fps, fns = [], [], []
    for i in range(1, n_class):
        p = preds == i
        t = targets == i
        tps.append(torch.sum(valid * (p & t)))
        fns.append(torch.sum(valid * (~p & t)))
        fps.append(torch.sum(valid * (p & ~t)))
    tp, fp, fn = mesh.global_sum(torch.stack(tps), torch.stack(fps), torch.stack(fns))
    return F1State(tp=state.tp + tp, fp=state.fp + fp, fn=state.fn + fn)


def compute_f1(state: F1State, n_class: int) -> Tuple[float, Optional[np.ndarray]]:
    """Finalize: per-class F1 (x100); damage aggregate = harmonic mean.
    Returns ``(scalar_f1, per_class_f1 or None)`` (reference f1.py:44-49)."""
    tp, fp, fn = (np.asarray(t.detach().cpu(), np.float32) for t in state)
    with np.errstate(divide="ignore", invalid="ignore"):
        f1_score = 200.0 * tp / (2.0 * tp + fp + fn)
        if n_class == 5:
            return float(4.0 / np.sum(1.0 / (f1_score + 1e-6))), f1_score
    return float(f1_score[0]), None
