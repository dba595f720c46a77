"""The eval step (port of ``tta_forward``/``make_eval_step`` of
``xview2_tpu/parallel/steps.py``): normalize, 4-flip TTA as one 4x-stacked
forward, the relayout copy, the loss and the F1 state.

The train step belongs to the next slice (ROADMAP Queue 1, train step).
"""

from __future__ import annotations

import torch

from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.layers import fused_tail_scope
from xview2_tpu_torch.models.unet import fused_head_defer_ok
from xview2_tpu_torch.ops.augment import eval_batch
from xview2_tpu_torch.ops.layout import relayout_standard
from xview2_tpu_torch.ops.losses import make_loss_fn
from xview2_tpu_torch.ops.metrics import F1State, update_f1_state


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Asking for CUDA without a CUDA device raises; nothing falls
    back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev


def tta_forward(model, x: torch.Tensor, use_tta: bool) -> torch.Tensor:
    """Flip-averaged logits (reference plt.py:42-48); NHWC flip dims (1, 2).
    The four flips run as ONE forward over a 4x-stacked batch."""
    if not use_tta:
        return model(x)
    xs = torch.cat([x, x.flip(1), x.flip(2), x.flip((1, 2))])
    p0, p1, p2, p3 = torch.chunk(model(xs), 4)
    return (p0 + p1.flip(1) + p2.flip(2) + p3.flip((1, 2))) / 4.0


def make_eval_step(cfg: Config, model, device="cuda"):
    """Build the eval step.  ``step_fn(f1_state, images, masks, valid)``
    takes uint8 (B, H, W, C) images, (B, H, W) masks and a (B,) 0/1
    ``valid`` vector (padded tail batches), moves them to ``device`` and
    returns ``(f1_state, loss, logits)``; the logits are f32 NHWC."""
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg.loss_str, cfg.type)
    n_class = cfg.n_metric_class
    defer = fused_head_defer_ok(cfg)

    @torch.inference_mode()
    def step_fn(f1_state: F1State, images, masks, valid):
        images = torch.as_tensor(images).to(dev, non_blocking=True)
        masks = torch.as_tensor(masks).to(dev, non_blocking=True)
        valid = torch.as_tensor(valid).to(dev, non_blocking=True)
        x = eval_batch(images, bgr=cfg.bgr)
        with fused_tail_scope(bool(cfg.fused_tail), defer_head=defer):
            logits = tta_forward(model, x, cfg.tta).to(torch.float32)
        logits = relayout_standard(logits)  # the model/loss seam, as in JAX
        loss = loss_fn(logits, masks.to(torch.int32), sample_valid=valid)
        f1_state = update_f1_state(f1_state, logits, masks, n_class=n_class,
                                   loss_str=cfg.loss_str, sample_valid=valid)
        return f1_state, loss, logits

    return step_fn
