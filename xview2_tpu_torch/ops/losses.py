"""Segmentation losses (port of ``focal_loss``, ``dice_loss``, ``ce_loss``,
``ohem_loss``, ``mse_loss``, ``coral_loss``, ``make_loss_fn``,
``packed_loss_view_labels`` and ``deep_supervision_loss`` of
``xview2_tpu/ops/losses.py``).

monai 0.4.0 numerics as in the JAX package: DiceLoss(softmax, to_onehot_y,
batch=True, smooth 1e-5) and FocalLoss(gamma=2) with its mean-over-classes
normalization; reductions are mask-weighted sums.  OHEM is the intended
per-image hard-negative top-k, as a rank mask.  Logits are NHWC ``(B, H, W,
C)``, labels ``(B, H, W)`` integers.

Every reduction over the batch is global: under a data-parallel group each
loss sends its numerator and denominator through ONE ``mesh.global_sum``,
so every rank computes the loss of the global batch (JAX's GSPMD sums); the
identity without one.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from xview2_tpu_torch.parallel import mesh

_SMOOTH_NR = 1e-5  # monai 0.4.0 DiceLoss defaults
_SMOOTH_DR = 1e-5


def _acc(logits: torch.Tensor) -> torch.Tensor:
    """Upcast to the accumulation dtype: f32 floor, f64 kept."""
    return logits.to(torch.promote_types(logits.dtype, torch.float32))


def _ensure_mask(labels: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    return mask.to(torch.float32)


def _one_hot(labels: torch.Tensor, n_class: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot`` semantics: an out-of-range label is an all-zero row."""
    classes = torch.arange(n_class, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def _global_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / max(count, 1)`` of the global batch."""
    total, count = mesh.global_sum(total, count)
    return total / torch.clamp(count, min=1.0)


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft Dice over softmax probabilities; background excluded iff the
    prediction has exactly 2 channels (reference loss.py:17-20)."""
    n_class = logits.shape[-1]
    w = _ensure_mask(labels, mask)
    probs = torch.softmax(_acc(logits), dim=-1)
    onehot = _one_hot(labels, n_class)
    if n_class == 2:
        probs = probs[..., 1:]
        onehot = onehot[..., 1:]
    w_ = w[..., None]
    intersection, pred_o, ground_o = mesh.global_sum(
        torch.sum(w_ * probs * onehot, dim=(0, 1, 2)), torch.sum(w_ * probs, dim=(0, 1, 2)),
        torch.sum(w_ * onehot, dim=(0, 1, 2)))
    f = 1.0 - (2.0 * intersection + _SMOOTH_NR) / (ground_o + pred_o + _SMOOTH_DR)
    return torch.mean(f)


def _true_class_logp(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-probability of the (clamped) true class, by a one-hot contraction
    as in the JAX package."""
    n_class = logp.shape[-1]
    onehot = _one_hot(labels.clamp(0, n_class - 1), n_class, logp.dtype)
    return torch.sum(logp * onehot, dim=-1)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               mask: Optional[torch.Tensor] = None, gamma: float = 2.0) -> torch.Tensor:
    """Multiclass focal loss, monai 0.4.0 normalization: the global pixel
    mean of the true-class focal term divided by the number of classes."""
    n_class = logits.shape[-1]
    w = _ensure_mask(labels, mask)
    logpt = _true_class_logp(torch.log_softmax(_acc(logits), dim=-1), labels)
    pt = torch.exp(logpt)
    per_pixel = -((1.0 - pt) ** gamma) * logpt
    total, count = mesh.global_sum(torch.sum(w * per_pixel), torch.sum(w))
    return total / (torch.clamp(count, min=1.0) * n_class)


def ce_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean cross-entropy (torch ``nn.CrossEntropyLoss`` semantics)."""
    w = _ensure_mask(labels, mask)
    nll = -_true_class_logp(torch.log_softmax(_acc(logits), dim=-1), labels)
    return _global_mean(torch.sum(w * nll), torch.sum(w))


def ohem_loss(logits: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Online hard example mining CE (reference loss.py:24-51): per image,
    every positive pixel (label > 0) and the ``max(clip(Cn/4, min 5),
    2*Cp)`` negatives of largest CE.  A stable descending sort ranks the
    negatives; positives sink to the end.

    With a pixel mask (the post task) the reference's gather makes every
    pixel a 1-pixel image whose budget keeps it, so OHEM is the masked mean
    CE, as in the JAX package."""
    if mask is not None:
        return ce_loss(logits, labels, mask)
    b = logits.shape[0]
    nll = -_true_class_logp(torch.log_softmax(_acc(logits), dim=-1), labels).reshape(b, -1)
    pos = (labels > 0).reshape(b, -1)
    cp = pos.sum(dim=1)
    cn = (~pos).sum(dim=1)
    budget = torch.maximum(torch.clamp(cn.to(torch.float32) / 4.0, min=5.0),
                           2.0 * cp.to(torch.float32))
    budget = torch.minimum(budget.to(torch.int64), cn)
    neg_scores = torch.where(pos, torch.full_like(nll, -torch.inf), nll)
    order = torch.sort(-neg_scores, dim=1, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    keep = pos | (~pos & (ranks < budget[:, None]))
    total = torch.sum(torch.where(keep, nll, torch.zeros_like(nll)))
    return _global_mean(total, keep.sum().to(nll.dtype))


def mse_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean squared error on ``relu(logits[..., 0])`` (reference
    loss.py:92-94)."""
    w = _ensure_mask(labels, mask)
    pred = torch.relu(_acc(logits)[..., 0])
    err = (pred - labels.to(torch.float32)) ** 2
    return _global_mean(torch.sum(w * err), torch.sum(w))


# CORAL cumulative-level targets of the 4 ordinal damage classes (reference
# loss.py:58)
_CORAL_LEVELS = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (1.0, 1.0, 1.0))


def coral_loss(logits: torch.Tensor, labels: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ordinal regression (CORAL) on 3 cumulative level logits (reference
    loss.py:54-65): per pixel ``-sum_k[logsigmoid(x_k)*l_k + (logsigmoid(x_k)
    - x_k)*(1 - l_k)]``, the levels a one-hot of ``clip(labels, 0, 3)`` times
    the 4x3 table, as in the JAX package."""
    w = _ensure_mask(labels, mask)
    x = _acc(logits)
    table = torch.tensor(_CORAL_LEVELS, dtype=torch.float32, device=logits.device)
    levels = _one_hot(labels.clamp(0, 3), 4) @ table
    logpt = torch.nn.functional.logsigmoid(x)
    per_pixel = torch.sum(logpt * levels + (logpt - x) * (1.0 - levels), dim=-1)
    return -_global_mean(torch.sum(w * per_pixel), torch.sum(w))


_LOSS_FNS = {"dice": dice_loss, "focal": focal_loss, "ce": ce_loss, "ohem": ohem_loss,
             "mse": mse_loss, "coral": coral_loss}


def make_loss_fn(loss_str: str, task_type: str) -> Callable[..., torch.Tensor]:
    """The combined loss for ``--loss_str`` (reference loss.py:78-101).

    For the post task supervision is restricted to building pixels with
    labels shifted down by one, and label 255 (un-classified) is masked."""
    terms = loss_str.split("+")
    for t in terms:
        if t not in _LOSS_FNS:
            raise ValueError(f"unknown loss term {t!r}")
    is_post = task_type == "post"

    def loss_fn(logits: torch.Tensor, labels: torch.Tensor,
                sample_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``sample_valid``: optional (B,) weights for padded eval batches."""
        labels = labels.to(torch.int64)
        mask = None
        shifted = labels
        if is_post:
            mask = ((labels > 0) & (labels != 255)).to(torch.float32)
            shifted = torch.clamp(labels - 1, min=0)
        if sample_valid is not None:
            sv = sample_valid.to(torch.float32)[:, None, None]
            mask = sv * (mask if mask is not None else _ensure_mask(labels, None))
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for t in terms:
            total = total + _LOSS_FNS[t](logits, shifted, mask)
        return total

    return loss_fn


def packed_loss_view_labels(labels: torch.Tensor) -> torch.Tensor:
    """(B, H, W) fine labels -> (B, H/2, 2W) under the packed loss view.

    The s2d-packed output head emits train-mode logits as ``(B, H/2, 2W, n)``
    with fine pixel ``(2i+di, 2j+dj)`` at ``[i, j*4 + di*2 + dj]``
    (``models/layers.OutputBlock``).  This is the label tensor under the same
    pixel permutation, so every per-pixel and global loss term is unchanged."""
    b, h, w = labels.shape
    y = labels.reshape(b, h // 2, 2, w // 2, 2).permute(0, 1, 3, 2, 4)  # [b, i, j, di, dj]
    return y.reshape(b, h // 2, 2 * w)


def deep_supervision_loss(loss_fn: Callable[..., torch.Tensor], outputs: Sequence[torch.Tensor],
                          labels: torch.Tensor,
                          main_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted deep-supervision objective (reference ``model/plt.py:69-77``):
    ``loss(out) + sum_i 0.5^(i+1) * loss(ds_i, nearest-downsampled labels)``,
    normalized by ``1/(2 - 2^-len(outputs))``.

    ``main_labels``: the labels of ``outputs[0]`` when it comes in another
    pixel arrangement than the fine ``labels`` (the packed loss view); the
    DS heads always read downsamplings of the fine ``labels``, torch's
    nearest rule ``src = floor(dst * in / out)``."""
    total = loss_fn(outputs[0], labels if main_labels is None else main_labels)
    h0, w0 = labels.shape[1], labels.shape[2]
    for i, out in enumerate(outputs[1:]):
        h, w = out.shape[1], out.shape[2]
        iy = torch.floor(torch.arange(h, device=labels.device) * (h0 / h)).to(torch.int64)
        ix = torch.floor(torch.arange(w, device=labels.device) * (w0 / w)).to(torch.int64)
        total = total + (0.5 ** (i + 1)) * loss_fn(out, labels[:, iy][:, :, ix])
    return (1.0 / (2.0 - 2.0 ** (-len(outputs)))) * total
