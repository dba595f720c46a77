"""Plain reference of the losses, the deep-supervision weighting, the F1
counters and the AdamW update of the xView2 recipe.

Losses (monai 0.4.0 numerics of the xView2 reference): soft Dice over the
softmax with the background left out for two classes (smooth 1e-5), focal
loss with gamma 2 divided by the number of classes, CORAL's ordinal
log-likelihood over three cumulative levels.  The damage task supervises
building pixels only (labels 1..4 shifted down by one; 0 and 255 masked).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

CORAL_LEVELS = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (1.0, 1.0, 1.0))


def _one_hot(labels, n, dtype=torch.float32):
    return (labels[..., None] == torch.arange(n, device=labels.device)).to(dtype)


def dice(logits, labels, w):
    n = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    onehot = _one_hot(labels, n, logits.dtype)
    if n == 2:
        probs, onehot = probs[..., 1:], onehot[..., 1:]
    w = w[..., None]
    inter = (w * probs * onehot).sum(dim=(0, 1, 2))
    pred, ground = (w * probs).sum(dim=(0, 1, 2)), (w * onehot).sum(dim=(0, 1, 2))
    return torch.mean(1.0 - (2.0 * inter + 1e-5) / (ground + pred + 1e-5))


def focal(logits, labels, w):
    n = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    logpt = (logp * _one_hot(labels.clamp(0, n - 1), n, logits.dtype)).sum(dim=-1)
    term = -((1.0 - torch.exp(logpt)) ** 2) * logpt
    return (w * term).sum() / (w.sum().clamp(min=1.0) * n)


def coral(logits, labels, w):
    x = logits
    levels = _one_hot(labels.clamp(0, 3), 4, x.dtype) @ torch.tensor(CORAL_LEVELS, dtype=x.dtype,
                                                                      device=x.device)
    logpt = F.logsigmoid(x)
    per_pixel = (logpt * levels + (logpt - x) * (1.0 - levels)).sum(dim=-1)
    return -(w * per_pixel).sum() / w.sum().clamp(min=1.0)


TERMS = {"dice": dice, "focal": focal, "coral": coral}


def loss(loss_str: str, task: str, logits, labels, valid=None, dtype=torch.float32,
         terms: Dict[str, Callable] = TERMS):
    """The sum of the ``loss_str`` terms, computed in ``dtype`` (float32, as
    the configuration states; the control's bfloat16); ``valid`` (B,) weighs
    samples.  ``terms``: each term's ``term(logits, labels, w)`` (a cell's
    terms, found by name, beside ``TERMS``)."""
    unknown = set(loss_str.split("+")) - set(terms)
    if unknown:
        raise ValueError(f"the reference has the loss terms {sorted(terms)} only, "
                         f"not {sorted(unknown)}")
    labels = labels.to(torch.int64)
    logits = logits.to(dtype)
    if task == "post":
        w = ((labels > 0) & (labels != 255)).to(dtype)
        labels = torch.clamp(labels - 1, min=0)
    else:
        w = torch.ones(labels.shape, dtype=dtype, device=labels.device)
    if valid is not None:
        w = w * valid.to(dtype)[:, None, None]
    return sum(terms[t](logits, labels, w) for t in loss_str.split("+")).float()


def deep_supervised(loss_str: str, task: str, outputs: Sequence[torch.Tensor], labels,
                    dtype=torch.float32, terms: Dict[str, Callable] = TERMS):
    """``loss(out) + sum_i 0.5^(i+1) loss(ds_i, nearest-downsampled labels)``
    over ``1 / (2 - 2^-len(outputs))``."""
    total = loss(loss_str, task, outputs[0], labels, dtype=dtype, terms=terms)
    h0, w0 = labels.shape[1], labels.shape[2]
    for i, out in enumerate(outputs[1:]):
        h, w = out.shape[1], out.shape[2]
        iy = torch.floor(torch.arange(h, device=labels.device) * (h0 / h)).long()
        ix = torch.floor(torch.arange(w, device=labels.device) * (w0 / w)).long()
        total = total + 0.5 ** (i + 1) * loss(loss_str, task, out, labels[:, iy][:, :, ix],
                                              dtype=dtype, terms=terms)
    return total / (2.0 - 2.0 ** (-len(outputs)))


def f1_counts(loss_str: str, task: str, logits, targets, valid=None) -> torch.Tensor:
    """(3, classes) float64 tp, fp and fn of one batch (exact integers);
    localization counts class 1 over every pixel, damage classes 1..4 over
    building pixels."""
    targets = targets.to(torch.int64)
    if task == "post":
        if loss_str == "coral":
            preds = (torch.sigmoid(logits.float()) > 0.5).sum(dim=-1) + 1
        else:
            preds = torch.argmax(logits, dim=-1) + 1
        w, classes = (targets > 0).double(), range(1, 5)
    else:
        preds, w, classes = torch.argmax(logits, dim=-1), torch.ones_like(targets).double(), (1,)
    if valid is not None:
        w = w * valid.double()[:, None, None]
    rows = []
    for c in classes:
        p, t = preds == c, targets == c
        rows.append(torch.stack([(w * (p & t)).sum(), (w * (p & ~t)).sum(),
                                 (w * (~p & t)).sum()]))
    return torch.stack(rows, dim=1)


class AdamW:
    """Bias-corrected Adam with decoupled weight decay (optax ``adamw``):
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``."""

    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / bc1) / ((v / bc2).sqrt() + self.eps)
            if self.wd:
                upd = upd + self.wd * p
            p.sub_(self.lr * upd)
            p.grad = None


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}
