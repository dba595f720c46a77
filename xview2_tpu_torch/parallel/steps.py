"""The train and eval steps (port of ``xview2_tpu/parallel/steps.py``).

Train: on-device augmentation of raw uint8 tiles or pre/post pairs (the
albumentations chain, or the crop and one AutoAugment draw with
``--autoaugment``), the packed loss view of the labels, the relayout of
labels and logits, the forward in train mode (batch statistics, running-stat
updates, the fused tail), the loss (with ``--deep_supervision`` the weighted
sum over the main and the two DS heads), the backward and the optimizer
update.
Eval: normalize, 4-flip TTA as one 4x-stacked forward, the relayout copy,
the loss and the F1 state.

The JAX step is a pure function of a donated state; here the model's
parameters, its BatchNorm buffers and the optimizer state are updated IN
PLACE and ``TrainState`` only carries the references and the step count.

``--remat`` (JAX ``steps.py:150-177``): ``tail`` normalizes+activates each
stock BatchNorm in a local checkpoint (``layers.remat_tail_scope``; the
fused tail is off); ``full`` runs the forward and the loss under one
non-reentrant ``torch.utils.checkpoint`` that saves nothing and recomputes
everything in the backward; ``dots`` is the same checkpoint with a
selective policy that saves the outputs of ``aten.convolution``, ``mm``,
``addmm`` and ``bmm`` (JAX ``dots_saveable``) and recomputes the rest, the
hand-written kernels included.  The recomputation leaves the BatchNorm
running statistics alone and replays K2's per-channel sums, so the step
updates the statistics once and the backward sees the first forward's
folds bit for bit.

``--gpus N`` (``parallel/mesh.py``): each rank runs these steps on its B
rows of the global batch of N*B.  The augmentation draws for the global
batch and keeps the rank's rows, BatchNorm, the losses and the F1 counts
reduce over the ranks, and the gradients are averaged between the backward
and the update, so every rank computes the single-device step on the global
batch and holds the same parameters.  Without a group nothing of this
sends a collective.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.layers import (fold_eval_bn_scope, frozen_running_stats,
                                            fused_tail_scope, remat_tail_scope)
from xview2_tpu_torch.models.unet import emits_packed_loss_view, fused_head_defer_ok
from xview2_tpu_torch.ops.augment import augment_batch, eval_batch
from xview2_tpu_torch.ops.layout import relayout_standard
from xview2_tpu_torch.ops.losses import (deep_supervision_loss, make_loss_fn,
                                         packed_loss_view_labels)
from xview2_tpu_torch.ops.metrics import F1State, update_f1_state
from xview2_tpu_torch.ops.packed_fused_conv import sums_tape
from xview2_tpu_torch.parallel import mesh
from xview2_tpu_torch.train.optimizers import LearningRate, lr_at


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
        with fold_eval_bn_scope(bool(cfg.fold_eval_bn)), \
                fused_tail_scope(bool(cfg.fused_tail), defer_head=defer):
            logits = tta_forward(model, x, cfg.tta).to(torch.float32)
        logits = relayout_standard(logits)  # the model/loss seam, as in JAX
        loss = loss_fn(logits, masks.to(torch.int32), sample_valid=valid)
        f1_state = update_f1_state(f1_state, logits, masks, n_class=n_class,
                                   loss_str=cfg.loss_str, sample_valid=valid)
        return f1_state, loss, logits

    return step_fn


@dataclasses.dataclass
class TrainState:
    """The step count with the model and the optimizer it counts for."""

    step: int
    model: torch.nn.Module
    opt: torch.optim.Optimizer


def init_train_state(model: torch.nn.Module, opt: torch.optim.Optimizer,
                     device="cuda") -> TrainState:
    """Move the model to ``device`` (the optimizer keeps pointing at the same
    parameters; its state is created on first use) and start at step 0."""
    model.to(resolve_device(device))
    return TrainState(step=0, model=model, opt=opt)


def step_generator(cfg: Config, global_step: int, device) -> torch.Generator:
    """The random stream of one train step: a function of ``(cfg.seed ^
    0x5EED, global_step)`` only, so a resumed run repeats an unbroken one
    and every rank of a data-parallel step holds the same stream."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed((((cfg.seed ^ 0x5EED) & 0xFFFFFFFF) << 31) ^ global_step)
    return gen


def check_train_supported(cfg: Config) -> None:
    """Raise for every train-step option outside the ported slices."""
    if cfg.spatial_shards != 1:
        raise NotImplementedError("--spatial_shards > 1 is not ported yet "
                                  "(ROADMAP Queue 1, --spatial_shards)")


def forward_loss(cfg: Config, model, loss_fn, x: torch.Tensor, y_main: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train-mode forward and loss of an augmented batch: the fused-tail
    scope, the model, the relayout of each output at the loss seam, the
    loss.  ``y_main`` is already in the main logits' view (see
    ``make_train_step``); ``y``: the fine labels the deep-supervision heads
    read (default ``y_main``, right when the main logits are fine)."""
    with fused_tail_scope(bool(cfg.fused_tail), defer_head=fused_head_defer_ok(cfg)):
        outs = model(x, True)
    if isinstance(outs, list):
        return deep_supervision_loss(loss_fn, [relayout_standard(o) for o in outs],
                                     y_main if y is None else y, main_labels=y_main)
    return loss_fn(relayout_standard(outs), y_main)


_DOTS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def rematerialized(fn: Callable, remat: str) -> Callable:
    """``fn`` (a forward and loss) under ``--remat dots|full``: a
    non-reentrant checkpoint whose recomputation runs with the running
    statistics frozen and K2's sums replayed from the first run
    (``packed_fused_conv.sums_tape``).  ``none`` and ``tail`` return ``fn``."""
    if remat in ("none", "tail"):
        return fn
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                  if remat == "dots" else None)

    def run(*args):
        tape, runs = [], []

        def body(*a):
            replay = bool(runs)
            runs.append(replay)
            with frozen_running_stats(replay), sums_tape(tape, replay):
                return fn(*a)

        kw = {"context_fn": context_fn} if context_fn else {}
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return run


def make_train_step(cfg: Config, model, opt: torch.optim.Optimizer, crop: int = 512,
                    device="cuda", learning_rate: LearningRate = None,
                    ) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """Build the augment+train step.  ``step_fn(state, images, masks, rng)``
    takes raw uint8 (B, H, W, 3|6) tiles and (B, H, W) labels (numpy or
    tensors; moved to ``device``) and a ``torch.Generator`` on the device
    (:func:`step_generator`); it updates the model, its BN buffers and the
    optimizer in place and returns ``(state, loss)``.  ``learning_rate`` is a
    float or a schedule of the update count (default ``cfg.lr``)."""
    dev = resolve_device(device)
    check_train_supported(cfg)
    loss_fn = make_loss_fn(cfg.loss_str, cfg.type)
    packed_view = emits_packed_loss_view(cfg)
    lr = cfg.lr if learning_rate is None else learning_rate
    loss_of = rematerialized(functools.partial(forward_loss, cfg, model, loss_fn), cfg.remat)

    def step_fn(state: TrainState, images, masks, rng: torch.Generator):
        images = torch.as_tensor(images).to(dev, non_blocking=True)
        masks = torch.as_tensor(masks).to(dev, non_blocking=True)
        with torch.no_grad():
            x, y = augment_batch(rng, images, masks, crop=crop, bgr=cfg.bgr,
                                 use_autoaugment=cfg.autoaugment, rank=mesh.rank(),
                                 world=mesh.world_size())
            # the packed head emits train logits as a (B, H/2, 2W, n) pixel
            # permutation; pair it with the same permutation of the labels.
            # The fine labels are read only by the deep-supervision heads.
            if packed_view:
                y_main = relayout_standard(packed_loss_view_labels(y))
                y = relayout_standard(y) if cfg.deep_supervision else y_main
            else:
                y = y_main = relayout_standard(y)
        with remat_tail_scope(cfg.remat == "tail"):
            loss = loss_of(x, y_main, y)
        loss.backward()
        mesh.average_gradients(model.parameters())
        for group in opt.param_groups:
            group["lr"] = lr_at(lr, state.step)
        opt.step()
        opt.zero_grad(set_to_none=True)
        state.step += 1
        return state, loss.detach()

    return step_fn


def make_train_multistep(*args, **kwargs):
    """K fused train steps in one device program (JAX ``lax.scan``); an
    experiment of the JAX package that its trainer does not use."""
    raise NotImplementedError("make_train_multistep is not ported to xview2_tpu_torch yet "
                              "(ROADMAP Queue 1, make_train_multistep)")
