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
Both steps enter ``--einsum_1x1``'s scope (``layers.einsum_1x1_scope``) as
JAX's do.  :func:`make_train_multistep` runs K train steps as one CUDA graph
on the card (K calls of the train step on the CPU).  Both steps mark their
phases with spans (``utils/spans.py``: ``train.step`` and its five phases,
``eval.step`` and its three), which record only while a profiler collects.

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

``--spatial_shards S`` (``parallel/mesh.py``): the S ranks of a data row
load, draw and augment the same samples (JAX's augmentation runs unmapped
over ``space``), and each keeps its band of the rows of the crops and
labels; the model runs on the band (halo exchanges in the convolutions,
pools and resizes, the pyramid pools summed over the space group), and the
losses and F1 counts sum over the world as before.  Every model option
runs there.  The eval step feeds each rank band s of the image and of its
three flips; the flips of the height come back from the mirror band,
gathered over the space group.  Under ``--remat dots|full`` the
recomputation repeats every collective of the forward (the halos, the
pools' space sums, BatchNorm's global sums, the replayed K2 sums'
all-reduce) in the forward's order, the same on every rank, since every
rank recomputes the same program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.layers import (einsum_1x1_scope, fold_eval_bn_scope,
                                            frozen_running_stats, fused_tail_scope,
                                            remat_tail_scope)
from xview2_tpu_torch.models.unet import emits_packed_loss_view, fused_head_defer_ok
from xview2_tpu_torch.ops.augment import (apply_augment, apply_augment_autoaugment,
                                          augment_batch, draw_augment,
                                          draw_augment_autoaugment, eval_batch)
from xview2_tpu_torch.ops.layout import relayout_standard
from xview2_tpu_torch.ops.losses import (deep_supervision_loss, make_loss_fn,
                                         packed_loss_view_labels)
from xview2_tpu_torch.ops.metrics import F1State, update_f1_state
from xview2_tpu_torch.ops.packed_fused_conv import sums_tape
from xview2_tpu_torch.parallel import mesh
from xview2_tpu_torch.train.optimizers import LearningRate, lr_at
from xview2_tpu_torch.utils.spans import span


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
    The four flips run as ONE forward over a 4x-stacked batch.

    Under ``--spatial_shards`` ``x`` is the whole image and the result this
    rank's band: the model sees band s of each flip; the flip of the height
    maps band s to band S-1-s, so the height-flipped logits are gathered
    over the space group (one collective) and flipped back whole."""
    if mesh.space_shards() > 1:
        if not use_tta:
            return model(mesh.band(x))
        xs = torch.cat([mesh.band(v) for v in (x, x.flip(1), x.flip(2), x.flip((1, 2)))])
        p0, p1, p2, p3 = torch.chunk(model(xs), 4)
        q1, q3 = torch.chunk(mesh.gather_rows(torch.cat([p1, p3])).flip(1), 2)
        return (p0 + mesh.band(q1) + p2.flip(2) + mesh.band(q3).flip(2)) / 4.0
    if not use_tta:
        return model(x)
    xs = torch.cat([x, x.flip(1), x.flip(2), x.flip((1, 2))])
    p0, p1, p2, p3 = torch.chunk(model(xs), 4)
    return (p0 + p1.flip(1) + p2.flip(2) + p3.flip((1, 2))) / 4.0


def make_eval_step(cfg: Config, model, device="cuda"):
    """Build the eval step.  ``step_fn(f1_state, images, masks, valid)``
    takes uint8 (B, H, W, C) images, (B, H, W) masks and a (B,) 0/1
    ``valid`` vector (padded tail batches), moves them to ``device`` and
    returns ``(f1_state, loss, logits)``; the logits are f32 NHWC, this
    rank's band of rows under ``--spatial_shards``."""
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg.loss_str, cfg.type)
    n_class = cfg.n_metric_class
    defer = fused_head_defer_ok(cfg)

    @torch.inference_mode()
    def step_fn(f1_state: F1State, images, masks, valid):
        with span("eval.step", dev):
            with span("eval.h2d", dev):
                images = torch.as_tensor(images).to(dev, non_blocking=True)
                masks = torch.as_tensor(masks).to(dev, non_blocking=True)
                valid = torch.as_tensor(valid).to(dev, non_blocking=True)
            check_band_height(images.shape[1], cfg.spatial_shards, "the eval tile")
            with span("eval.forward", dev):
                x = eval_batch(images, bgr=cfg.bgr)
                masks = mesh.band(masks)
                with fold_eval_bn_scope(bool(cfg.fold_eval_bn)), \
                        einsum_1x1_scope(bool(cfg.einsum_1x1)), \
                        fused_tail_scope(bool(cfg.fused_tail), defer_head=defer):
                    logits = tta_forward(model, x, cfg.tta).to(torch.float32)
            with span("eval.score", dev):
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


def check_band_height(height: int, spatial_shards: int, what: str) -> None:
    """Raise unless every band of the deepest (/32) map holds whole rows:
    ``height`` divisible by ``32 * spatial_shards``."""
    if spatial_shards > 1 and height % (32 * spatial_shards):
        raise ValueError(f"{what} height {height} is not divisible by 32 * --spatial_shards "
                         f"= {32 * spatial_shards}")


def forward_loss(cfg: Config, model, loss_fn, x: torch.Tensor, y_main: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train-mode forward and loss of an augmented batch: the
    ``--einsum_1x1`` and fused-tail scopes, the model, the relayout of each
    output at the loss seam, the loss.  ``y_main`` is already in the main
    logits' view (see ``make_train_step``); ``y``: the fine labels the
    deep-supervision heads read (default ``y_main``, right when the main
    logits are fine)."""
    with einsum_1x1_scope(bool(cfg.einsum_1x1)), \
            fused_tail_scope(bool(cfg.fused_tail), defer_head=fused_head_defer_ok(cfg)):
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


def _learner(cfg: Config, model) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``learn(x, y)``: the part of a train step between the augmentation and
    the optimizer, on this rank's rows of an augmented batch: the band of
    rows, the labels' loss views, the forward and loss (under ``--remat``),
    the backward and the gradients' average over the ranks.  Returns the
    loss, detached."""
    loss_fn = make_loss_fn(cfg.loss_str, cfg.type)
    packed_view = emits_packed_loss_view(cfg)
    loss_of = rematerialized(functools.partial(forward_loss, cfg, model, loss_fn), cfg.remat)

    def learn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with span("train.forward", x.device):
            with torch.no_grad():
                x, y = mesh.band(x), mesh.band(y)
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
        with span("train.backward", x.device):
            loss.backward()
            mesh.average_gradients(model.parameters())
        return loss.detach()

    return learn


def make_train_step(cfg: Config, model, opt: torch.optim.Optimizer, crop: int = 512,
                    device="cuda", learning_rate: LearningRate = None,
                    ) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """Build the augment+train step.  ``step_fn(state, images, masks, rng)``
    takes raw uint8 (B, H, W, 3|6) tiles and (B, H, W) labels (numpy or
    tensors; moved to ``device``) and a ``torch.Generator`` on the device
    (:func:`step_generator`); it updates the model, its BN buffers and the
    optimizer in place and returns ``(state, loss)``.  ``learning_rate`` is a
    float or a schedule of the update count (default ``cfg.lr``).  Under
    ``--spatial_shards`` the tiles are the data row's and each rank trains
    on its band of the crops."""
    dev = resolve_device(device)
    lr = cfg.lr if learning_rate is None else learning_rate
    learn = _learner(cfg, model)

    def step_fn(state: TrainState, images, masks, rng: torch.Generator):
        with span("train.step", dev):
            with span("train.h2d", dev):
                images = torch.as_tensor(images).to(dev, non_blocking=True)
                masks = torch.as_tensor(masks).to(dev, non_blocking=True)
            with span("train.augment", dev), torch.no_grad():
                x, y = augment_batch(rng, images, masks, crop=crop, bgr=cfg.bgr,
                                     use_autoaugment=cfg.autoaugment, rank=mesh.data_rank(),
                                     world=mesh.data_world())
            loss = learn(x, y)
            with span("train.update", dev):
                for group in opt.param_groups:
                    group["lr"] = lr_at(lr, state.step)
                opt.step()
                opt.zero_grad(set_to_none=True)
            state.step += 1
            return state, loss

    return step_fn


def launch_counters() -> tuple:
    """The wrappers of the hand-written kernels K1-K8 and of the eval
    BatchNorm epilogue, each of which counts its kernel's launches in
    ``.launches``."""
    from xview2_tpu_torch.ops import layout, norm_act, rowshift, small_conv
    from xview2_tpu_torch.ops import packed_fused_conv as pfc

    return (layout.relayout_cuda, pfc.conv_bn_fused, pfc.head_conv_fused, pfc.conv_bn_wgrad,
            pfc.conv_bn_dgrad, rowshift.row_shift_cuda, small_conv.small_conv_fwd,
            small_conv.small_conv_wgrad, norm_act.norm_act_cuda)


def check_graph_supported() -> None:
    """Raise ``NotImplementedError``, naming its ROADMAP item, where a CUDA
    graph of train steps cannot hold the step: under a gloo group (the CPU's,
    or two ranks on one card), whose collectives are staged through the host.
    Every option of the step runs in the graph (``--autoaugment`` in
    AutoAugment's static form)."""
    if mesh.active() is not None and dist.get_backend() != "nccl":
        raise NotImplementedError(
            f"make_train_multistep on CUDA: a {dist.get_backend()} group stages its "
            "collectives through the host, which a CUDA graph cannot capture; it needs "
            "NCCL, one rank per card (ROADMAP Queue 1, the graph path under a gloo group)")


def _leaves(d) -> List[torch.Tensor]:
    """The tensors of a draws dataclass (nested ones included), in order."""
    out = []
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if dataclasses.is_dataclass(v):
            out += _leaves(v)
        elif v is not None:
            out.append(v)
    return out


def _static_like(d):
    """A copy of a draws dataclass whose tensors are fresh buffers."""
    def fresh(v):
        return _static_like(v) if dataclasses.is_dataclass(v) else None if v is None else v.clone()

    return dataclasses.replace(d, **{f.name: fresh(getattr(d, f.name))
                                     for f in dataclasses.fields(d)})


def graph_draws(cfg: Config, step: int, images: torch.Tensor, masks: torch.Tensor,
                crop: int):
    """The augmentation draws of train step ``step`` on one batch of raw
    ``images`` and ``masks`` (on their device): those that
    :func:`make_train_step` draws from ``step_generator(cfg, step)``, bit for
    bit, for this rank's rows."""
    gen = step_generator(cfg, step, masks.device)
    if cfg.autoaugment:
        return draw_augment_autoaugment(gen, masks, crop, mesh.data_rank(), mesh.data_world())
    return draw_augment(gen, masks, crop, images.shape[-1], mesh.data_rank(),
                        mesh.data_world())


@torch.no_grad()
def graph_augment(cfg: Config, images: torch.Tensor, masks: torch.Tensor, draws, k: int,
                  crop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch ``k`` of the stacked inputs augmented by ``draws[k]``
    (:func:`graph_draws`), as a graph holds it: under ``--autoaugment``
    AutoAugment's static form."""
    if cfg.autoaugment:
        return apply_augment_autoaugment(images[k], masks[k], draws[k], crop, cfg.bgr,
                                         static=True)
    return apply_augment(images[k], masks[k], draws[k], crop, cfg.bgr)


def graph_body(cfg: Config, learn, opt, images: torch.Tensor, masks: torch.Tensor, draws,
               k: int, crop: int) -> torch.Tensor:
    """Step ``k`` of a graph of train steps as :class:`_GraphedSteps`
    captures it: :func:`graph_augment`, the learner (:func:`_learner`),
    update ``k`` of the optimizer's prepared table (:meth:`_Zoo.prepare`).
    Returns the loss.  Nothing in it reads back to the host, and it runs
    without capture on any device."""
    x, y = graph_augment(cfg, images, masks, draws, k, crop)
    loss = learn(x, y)
    opt.apply(k)
    opt.zero_grad(set_to_none=True)
    return loss


class _GraphedSteps:
    """K train steps as one CUDA graph (see :func:`make_train_multistep`)."""

    def __init__(self, cfg: Config, model, opt, nsteps: int, crop: int, dev: torch.device,
                 lr: LearningRate, step_fn):
        self.cfg, self.model, self.opt, self.nsteps = cfg, model, opt, nsteps
        self.crop, self.dev, self.lr, self.step_fn = crop, dev, lr, step_fn
        self.learn = _learner(cfg, model)
        self.graph, self.key = None, None

    def _key(self, images: torch.Tensor, masks: torch.Tensor) -> tuple:
        """What the graph holds by address or by shape: the inputs' shapes
        and the model's and the optimizer's tensors."""
        held = [t.data_ptr() for t in self.model.parameters()]
        held += [t.data_ptr() for t in self.model.buffers()]
        held += [t.data_ptr() for st in self.opt.state.values() for t in st.values()
                 if t.is_cuda]
        return (tuple(images.shape), images.dtype, tuple(masks.shape), masks.dtype,
                tuple(held))

    def _draw(self, step: int, k: int):
        return graph_draws(self.cfg, step, self.images[k], self.masks[k], self.crop)

    def _body(self, k: int) -> None:
        self.losses[k].copy_(graph_body(self.cfg, self.learn, self.opt, self.images,
                                        self.masks, self.draws, k, self.crop))

    def _lrs(self, step: int) -> List[float]:
        return [lr_at(self.lr, step + k) for k in range(self.nsteps)]

    def _eager_then_capture(self, state: TrainState, images, masks):
        """The K steps of this call eagerly on a side stream (the warm-up
        that capture needs), then the capture, which runs nothing."""
        self.graph = None
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            losses = []
            for k in range(self.nsteps):
                state, loss = self.step_fn(state, images[k], masks[k],
                                           step_generator(self.cfg, state.step, self.dev))
                losses.append(loss)
            losses = torch.stack(losses)
            self.images = torch.empty(images.shape, dtype=images.dtype, device=self.dev)
            self.masks = torch.empty(masks.shape, dtype=masks.dtype, device=self.dev)
            self.images.copy_(images)
            self.masks.copy_(masks)
            self.draws = [_static_like(self._draw(0, k)) for k in range(self.nsteps)]
            # the device constants of the augmentation the graph holds are made
            # here if the eager steps did not (under --autoaugment they group
            # by op and never run the static form): a capture cannot copy
            # from the host
            graph_augment(self.cfg, self.images, self.masks, self.draws, 0, self.crop)
            self.losses = torch.zeros_like(losses)
            self.opt.prepare(self._lrs(state.step), advance=False)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        torch.cuda.synchronize(self.dev)
        torch.cuda.empty_cache()  # the warm-up's blocks, before the graph's pool takes its own
        graph = torch.cuda.CUDAGraph()
        counters = launch_counters()
        before = [fn.launches for fn in counters]
        with torch.cuda.graph(graph):
            for k in range(self.nsteps):
                self._body(k)
        self.captured = [(fn, fn.launches - n) for fn, n in zip(counters, before)]
        self.replays = 0
        self.graph, self.key = graph, self._key(self.images, self.masks)
        return state, losses

    def __call__(self, state: TrainState, images, masks):
        images, masks = torch.as_tensor(images), torch.as_tensor(masks)
        if images.shape[0] != self.nsteps or masks.shape[0] != self.nsteps:
            raise ValueError(f"make_train_multistep({self.nsteps}): images {tuple(images.shape)} "
                             f"and masks {tuple(masks.shape)} must stack {self.nsteps} batches")
        if self.graph is None or self._key(images, masks) != self.key:
            return self._eager_then_capture(state, images, masks)
        with span("train.step", self.dev):
            with span("train.h2d", self.dev):
                if not images.is_cuda:  # pinned: an ordered copy that need not wait for the host
                    images, masks = images.pin_memory(), masks.pin_memory()
                self.images.copy_(images, non_blocking=True)
                self.masks.copy_(masks, non_blocking=True)
            with span("train.replay", self.dev):
                for k in range(self.nsteps):  # each step's draws, eagerly, as make_train_step's
                    for dst, src in zip(_leaves(self.draws[k]),
                                        _leaves(self._draw(state.step + k, k))):
                        dst.copy_(src)
                self.opt.prepare(self._lrs(state.step))
                self.graph.replay()
                self.replays += 1
            state.step += self.nsteps
            return state, self.losses.clone()

    def replayed_launches(self) -> Dict[str, int]:
        """The K1-K8 launches that the replays of the current graph made on
        the device, by wrapper name: what its capture counted, times the
        replays.  The wrappers' own ``.launches`` count only where they
        launch, so they count the capture and not the replays."""
        if self.graph is None:
            return {}
        return {fn.__name__: n * self.replays for fn, n in self.captured}


def make_train_multistep(cfg: Config, model, opt: torch.optim.Optimizer, nsteps: int,
                         crop: int = 512, device="cuda", learning_rate: LearningRate = None,
                         ) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """``nsteps`` train steps in one device program (JAX ``lax.scan``; an
    experiment of the JAX package that its trainer does not use, nor does
    this one).  ``multi(state, images, masks) -> (state, losses)`` takes
    (K, B, H, W, 3|6) uint8 tiles and (K, B, H, W) labels and returns the
    (K,) losses; step k draws from ``step_generator(cfg, state.step + k)``,
    so the result is that of K calls of :func:`make_train_step`: the losses,
    the parameters, the BatchNorm buffers, the optimizer state and
    ``state.step``.

    On the CPU it is those K calls.  On CUDA it is one CUDA graph of the K
    steps: the first call (and a call after the inputs' shapes, the model's
    or the optimizer's tensors changed) runs its K steps eagerly, which is
    the warm-up capture needs, and captures the graph, which runs nothing;
    later calls copy the inputs into the graph's static buffers, draw each
    step's augmentation eagerly from its generator into static draws (the
    draws of :func:`make_train_step`, bit for bit), write the optimizer's
    table of per-step scalars (:meth:`_Zoo.prepare`) and replay.  Each
    captured step is :func:`graph_body`: under ``--autoaugment`` it applies
    AutoAugment's static form (fixed shapes, no host round trip), where the
    eager step groups the samples by op on the host; the numbers are the
    same.  The hand-written kernels launch inside the graph on the capturing
    stream; their launch counters (:func:`launch_counters`) count the
    capture, not the replays, whose launches the graph's
    :meth:`_GraphedSteps.replayed_launches` tallies apart.  It raises under
    a gloo group (:func:`check_graph_supported`), before it touches a
    card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_graph_supported()
    step_fn = make_train_step(cfg, model, opt, crop=crop, device=dev,
                              learning_rate=learning_rate)
    if dev.type != "cuda":
        def multi(state: TrainState, images, masks):
            losses = []
            for k in range(nsteps):
                state, loss = step_fn(state, images[k], masks[k],
                                      step_generator(cfg, state.step, dev))
                losses.append(loss)
            return state, torch.stack(losses)

        return multi
    return _GraphedSteps(cfg, model, opt, nsteps, crop, dev,
                         cfg.lr if learning_rate is None else learning_rate, step_fn)
