"""The reference's train and eval steps, from raw uint8 batches to the
numbers the check compares.

Train: the first ``steps`` steps of a fresh model on the given batches, each
augmented from its own seeded draws, forward in train mode, the loss (deep
supervision where the model has it), the backward and AdamW.  Returns each
step's loss, the first step's gradient norm per leaf, and after the last
step each leaf's change and each BatchNorm running statistic's change.

Eval: the four-flip logits of a batch; the loss and
the F1 counts of given logits.

``ref``: the configuration's reference (``cells.Reference``), whose
``build`` makes the model and whose ``terms`` make the loss.

``fault`` plants in a train step one of the faults a run must be caught in,
for reading how far each number moves: ``"frozen"`` (no update), ``"half"``
(half of the batch, the mean over the rest), ``"altered"`` (the first
sample's logits negated and scaled by ten where the model produces them).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from xv2bench.reference import augment, losses
from xv2bench.reference.model import Precision, forward_nhwc, tta_logits

ALTER = 10.0


def _model(ref, spec: dict, state: Dict[str, torch.Tensor], prec: Precision, device):
    with torch.device("meta"):
        model = ref.build(spec, prec)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model


def _alter(out):
    """The first sample's answer replaced by a confidently wrong one: its
    logits negated and scaled by ``ALTER``."""
    if isinstance(out, list):
        return [_alter(out[0])] + out[1:]
    return torch.cat([-ALTER * out[:1], out[1:]])


def train_readings(ref, spec: dict, state_fn: Callable[[], Dict[str, torch.Tensor]],
                   batches: List[Tuple[np.ndarray, np.ndarray]], seed: int, device,
                   prec: Precision, fault: Optional[str] = None) -> dict:
    """``state_fn()`` gives the initial weights (a fresh copy each call)."""
    if spec.get("optimizer") != "adamw":
        raise ValueError(f"the reference has AdamW only, not {spec.get('optimizer')!r}")
    model = _model(ref, spec, state_fn(), prec, device)
    params = dict(model.named_parameters())
    opt = losses.AdamW(list(params.values()), spec.get("lr", 3e-4),
                       spec.get("weight_decay", 0.0))
    crop, task = spec.get("train_crop", 512), spec["type"]
    out = {"losses": [], "grad": {}, "change": {}, "stats": {}}
    for step, (images, masks) in enumerate(batches):
        images = torch.from_numpy(images).to(device)
        masks = torch.from_numpy(masks).to(device)
        x, y = augment.augment_step(seed, step, images, masks, crop,
                                    bool(spec.get("autoaugment")))
        if fault == "half":
            x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
        logits = forward_nhwc(model, x, train=True)
        if fault == "altered":
            logits = _alter(logits)
        if isinstance(logits, list):
            loss = losses.deep_supervised(spec["loss_str"], task, logits, y, prec.loss_dtype,
                                          ref.terms)
        else:
            loss = losses.loss(spec["loss_str"], task, logits, y, dtype=prec.loss_dtype,
                               terms=ref.terms)
        loss.backward()
        if step == 0:
            out["grad"] = losses.leaf_norms({k: p.grad for k, p in params.items()})
        if fault == "frozen":
            for p in params.values():
                p.grad = None
        else:
            opt.step()
        out["losses"].append(float(loss.detach()))
        del logits, loss, x, y
    start = state_fn()
    with torch.no_grad():
        out["change"] = losses.leaf_norms({k: p - start[k] for k, p in params.items()})
        out["stats"] = losses.leaf_norms({k: b - start[k] for k, b in model.named_buffers()})
    del model, opt, params, start
    return out


@torch.inference_mode()
def eval_model(ref, spec: dict, state: Dict[str, torch.Tensor], prec: Precision, device):
    return _model(ref, spec, state, prec, device)


@torch.inference_mode()
def eval_logits(model, images: np.ndarray, device) -> torch.Tensor:
    """The four-flip float32 NHWC logits of a batch."""
    return tta_logits(model, augment.normalize(torch.from_numpy(images).to(device)))


@torch.inference_mode()
def judge_eval(ref, spec: dict, logits: torch.Tensor, masks: np.ndarray, valid: np.ndarray,
               dtype=torch.float32):
    """The loss (in ``dtype``) and the (3, classes) F1 counts the reference
    gives for ``logits`` of a batch."""
    masks_d = torch.from_numpy(masks).to(logits.device)
    valid_d = torch.from_numpy(valid).to(logits.device)
    loss = float(losses.loss(spec["loss_str"], spec["type"], logits, masks_d, valid_d, dtype,
                             ref.terms))
    return loss, losses.f1_counts(spec["loss_str"], spec["type"], logits, masks_d, valid_d).cpu()
