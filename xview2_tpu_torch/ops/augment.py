"""Eval-time input normalization (port of ``normalize``/``eval_batch`` of
``xview2_tpu/ops/augment.py``).

The train-time augmentations (zoom-crop, flips, noise, brightness/contrast,
AutoAugment) belong to the train slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(img: torch.Tensor, channels: int = 3, bgr: bool = False) -> torch.Tensor:
    """A.Normalize semantics: (img/255 - mean)/std, per 3-channel group.

    ``bgr=True`` reverses each RGB triple first, reproducing the reference's
    ``cv2.imread`` channel order (``pytorch_loader.py:39-42``)."""
    img = img.to(torch.float32) / 255.0
    reps = channels // 3
    if bgr:
        img = img.reshape(img.shape[:-1] + (reps, 3)).flip(-1).reshape(img.shape)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device).repeat(reps)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device).repeat(reps)
    return (img - mean) / std


def eval_batch(images: torch.Tensor, bgr: bool = False) -> torch.Tensor:
    """Eval-time: normalize only, full tiles (reference pytorch_loader.py:151-171)."""
    return normalize(images, images.shape[-1], bgr)
