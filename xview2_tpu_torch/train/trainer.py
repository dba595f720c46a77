"""Epoch driver: ``fit`` and ``test`` (port of
``xview2_tpu/train/trainer.py``).

``fit(cfg)`` trains with per-epoch validation, keeps ``best`` (by F1) and
``last`` checkpoints with the optimizer state, honours ``--patience`` and
logs one JSON line per epoch; a run resumed from ``--ckpt`` repeats an
unbroken one bit for bit (loader epoch, step count and per-step random
streams are restored).  The initialization's precedence is JAX's: the
ImageNet encoder of ``--pretrained_enc`` (when the file exists) < the
localization encoder of ``--ckpt_pre`` (a damage run, when that checkpoint
exists) < the ``--ckpt`` resume.  ``test(cfg)`` restores a checkpoint, runs the holdout split through
the eval step, dumps ``probs/*.npy`` and ``targets/*.png`` in the JAX
package's format (localization: sigmoid of channel 1, ``(H, W)``; damage:
the class softmax channel-first, ``(4, H, W)``; float32, filenames
``test_{localization|damage}_{idx:05d}.npy`` and ``..._target.png``) and
logs the F1.

``--gpus N`` (one process per GPU, ``parallel/mesh.py``; ``main`` joins or
spawns the ranks): every rank loads its rows of each global batch of
``N * batch_size``, rank 0's model is broadcast after each initialization,
the steps compute the single-device step on the global batch, so the F1 and
the early-stopping decision are the same on every rank; rank 0 writes the
index, the checkpoints and the log, and each rank the eval dumps of its own
rows under their global index, so the file set is the single-device run's.
Under ``--spatial_shards S`` the global batch is ``batch_size * (N / S)``:
the S ranks of a data row load the same whole tiles and each computes on
its band of their rows; the eval dumps gather the bands over the space
group and the data row's first rank writes them.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import time

import numpy as np
import torch
from PIL import Image

from xview2_tpu_torch.config import Config, apply_precision
from xview2_tpu_torch.data.pipeline import (Loader, decoder_status, make_test_loader,
                                            make_train_loaders)
from xview2_tpu_torch.models.encoder import encoder_channels
from xview2_tpu_torch.models.pretrained import apply_pretrained_encoder
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.ops.losses import make_loss_fn
from xview2_tpu_torch.ops.metrics import compute_f1, init_f1_state
from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
from xview2_tpu_torch.parallel import mesh
from xview2_tpu_torch.parallel.steps import (TrainState, check_band_height, init_train_state,
                                             make_eval_step, make_train_step, resolve_device,
                                             step_generator)
from xview2_tpu_torch.parallel.transplant import transplant_encoder
from xview2_tpu_torch.train.logging import MetricsLogger, epoch_metrics, test_metrics
from xview2_tpu_torch.train.optimizers import build_optimizer, check_optimizer
from xview2_tpu_torch.train.scheduler import noam_schedule
from xview2_tpu_torch.utils import spans
from xview2_tpu_torch.weights import from_flax, to_flax


def _save_predictions(cfg: Config, logits: torch.Tensor, targets: np.ndarray,
                      valid: np.ndarray, start_idx: int) -> int:
    """Write per-image prob .npy + target .png (reference plt.py:126-144):
    localization the sigmoid of channel 1; damage the softmax over the
    classes, channel-first as ``post_process`` reads it, or with ``--loss_str
    coral`` the class ``count(sigmoid > 0.5) + 1`` and with ``mse``
    ``round(max(logit, 0)) + 1``, both (H, W) float32."""
    probs_dir = os.path.join(cfg.results, "probs")
    targets_dir = os.path.join(cfg.results, "targets")
    os.makedirs(probs_dir, exist_ok=True)
    os.makedirs(targets_dir, exist_ok=True)
    logits = logits.to(torch.float32)
    task = "localization" if cfg.type == "pre" else "damage"
    if cfg.type == "pre":
        probs = torch.sigmoid(logits[..., 1])
    elif cfg.loss_str == "coral":
        probs = (torch.sigmoid(logits) > 0.5).sum(dim=-1).to(torch.float32) + 1
    elif cfg.loss_str == "mse":
        probs = torch.round(torch.clamp(logits[..., 0], min=0)) + 1
    else:
        probs = torch.softmax(logits, dim=-1).permute(0, 3, 1, 2)
    probs = probs.cpu().numpy()
    idx = start_idx
    for prob, target, v in zip(probs, targets, valid):
        if v <= 0:
            continue
        fname = os.path.join(probs_dir, f"test_{task}_{idx:05d}")
        np.save(fname, prob)
        Image.fromarray(target.astype(np.uint8)).save(
            os.path.join(targets_dir, f"test_{task}_{idx:05d}_target.png"))
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


def _is_improvement(f1: float, best_f1: float, best_exists: bool) -> bool:
    """Best-checkpoint selection, NaN-safe: under a NaN F1 a best checkpoint
    is still written once, so eval always has one, but NaN never counts as an
    improvement afterwards."""
    if math.isnan(f1):
        return not best_exists
    return f1 >= best_f1


def _warn_nan_f1(f1: float, per_class, epoch: int, patience_left: int) -> None:
    """Say WHY the validation F1 is NaN instead of burning patience silently
    (the damage harmonic mean is 0/0 when a class never occurs in the split)."""
    if not math.isnan(f1) or per_class is None:
        return
    absent = [i + 1 for i, v in enumerate(per_class) if math.isnan(float(v))]
    print(f"WARNING: val F1 is NaN at epoch {epoch}: damage class(es) {absent} "
          f"never occur in the val split (no predictions or targets); "
          f"early-stopping patience is still being consumed "
          f"({patience_left} epoch(s) left)", flush=True)


def initial_model(cfg: Config) -> torch.nn.Module:
    """The model a fresh run starts from: torch's default initializers,
    drawn from ``--seed`` alone (the global random state is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg)
    return model.double() if cfg.precision == 64 else model


class Runner:
    """Holds the device, the model, the optimizer and the steps of one run."""

    def __init__(self, cfg: Config, steps_per_epoch: int, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        apply_precision(cfg)
        self.model = initial_model(cfg)
        if cfg.use_scheduler:
            self.learning_rate = noam_schedule(cfg.init_lr, cfg.lr, cfg.final_lr, cfg.warmup,
                                               cfg.epochs, max(steps_per_epoch, 1))
        else:
            self.learning_rate = cfg.lr
        self.opt = build_optimizer(cfg, self.model.parameters(), self.learning_rate)
        self.state = init_train_state(self.model, self.opt, device=self.device)
        mesh.broadcast_module(self.model)
        self.train_step = make_train_step(cfg, self.model, self.opt, crop=cfg.train_crop,
                                          device=self.device, learning_rate=self.learning_rate)
        self.eval_step = make_eval_step(cfg, self.model, device=self.device)

    def restore(self, path: str) -> dict:
        """Load a training checkpoint into the model, the optimizer and the
        step count; returns its metadata."""
        payload, meta = ckpt_lib.restore_raw(path)
        self.model.load_state_dict(from_flax(payload["params"], payload["batch_stats"]),
                                   strict=True)
        ckpt_lib.load_optimizer_arrays(self.model, self.opt, payload.get("opt_state", {}))
        self.state.step = int(payload.get("train", {}).get("step", 0))
        return meta

    def save(self, path: str, *, epoch: int, best_f1: float, best_epoch: int) -> None:
        def arrays():
            return (*to_flax(self.model.state_dict()),
                    ckpt_lib.optimizer_arrays(self.model, self.opt))

        ckpt_lib.save_on_main(path, arrays, epoch=epoch, best_f1=best_f1,
                              best_epoch=best_epoch, cfg=self.cfg, step=self.state.step)

    def run_eval(self, loader: Loader):
        f1_state = init_f1_state(self.cfg.n_metric_class, device=self.device)
        losses = []
        for batch in loader:
            f1_state, loss, _ = self.eval_step(f1_state, batch.image, batch.mask, batch.valid)
            losses.append(loss)
        val_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        f1, per_class = compute_f1(f1_state, self.cfg.n_metric_class)
        return float(f1), per_class, val_loss


def _check_fit_supported(cfg: Config) -> None:
    """Raise for a train option the port cannot run BEFORE touching the
    data: an unknown encoder, loss term or optimizer."""
    encoder_channels(cfg.encoder)
    make_loss_fn(cfg.loss_str, cfg.type)
    check_optimizer(cfg)


def _say(msg: str) -> None:
    """Print on rank 0 (every rank has the same to say)."""
    if mesh.is_main():
        print(msg, flush=True)


def fit(cfg: Config, device="cuda") -> str:
    """Train with per-epoch validation; returns the best checkpoint path.
    Runs on ``device``, CUDA by default; under a process group of
    ``--gpus`` ranks, on this rank's rows."""
    resolve_device(device)
    _check_fit_supported(cfg)
    mesh.check_world(cfg.gpus, cfg.spatial_shards)
    train_loader, val_loader = make_train_loaders(cfg, mesh.data_rank(), mesh.data_world())
    _say(f"input decoder: {decoder_status(cfg)}")
    runner = Runner(cfg, len(train_loader), device=device)
    state: TrainState = runner.state

    if cfg.pretrained_enc and os.path.exists(cfg.pretrained_enc):
        variant = "siamese" if cfg.type == "pre" else cfg.dmg_model
        copied = apply_pretrained_encoder(runner.model, cfg.pretrained_enc, variant)
        mesh.broadcast_module(runner.model)
        _say(f"loaded pretrained encoder from {cfg.pretrained_enc} ({len(copied)} tensors)")

    if cfg.type == "post" and ckpt_lib.checkpoint_exists(cfg.ckpt_pre):
        loc, _ = ckpt_lib.restore_raw(cfg.ckpt_pre, ("params", "batch_stats"))
        copied = transplant_encoder(cfg.dmg_model, runner.model,
                                    from_flax(loc["params"], loc["batch_stats"]))
        mesh.broadcast_module(runner.model)
        _say(f"transplanted localization encoder from {cfg.ckpt_pre} ({len(copied)} tensors)")

    start_epoch = 0
    best_f1, best_epoch = 0.0, 0
    if ckpt_lib.checkpoint_exists(cfg.ckpt):
        meta = runner.restore(cfg.ckpt)
        start_epoch = meta["epoch"] + 1
        best_f1, best_epoch = meta["best_f1"], meta["best_epoch"]
        # the loader's shuffle seed is a function of its epoch counter, which
        # starts at 0 for every fresh Loader: restore it, or a resumed run
        # replays epoch 0's sample order instead of epoch E's
        train_loader.epoch = start_epoch
        _say(f"resumed from {cfg.ckpt} at epoch {start_epoch}")

    logger = MetricsLogger(cfg.results, cfg.logname) if mesh.is_main() else None
    best_path = os.path.join(cfg.results, "checkpoints", "best")
    last_path = os.path.join(cfg.results, "checkpoints", "last")
    patience_left = cfg.patience

    prof = None
    if cfg.profile and mesh.is_main():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if runner.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        spans.reset()
        prof.start()
    # stop after 6 steps from here (resume-safe), or at loop exit if the run
    # is shorter: a trace must never be left running
    profile_stop_at = state.step + 6

    def stop_profile():
        nonlocal prof
        prof.stop()
        os.makedirs(os.path.join(cfg.results, "profile"), exist_ok=True)
        prof.export_chrome_trace(os.path.join(cfg.results, "profile", "trace.json"))
        with open(os.path.join(cfg.results, "profile", "spans.json"), "w") as f:
            json.dump({k: dataclasses.asdict(v) for k, v in spans.summary().items()}, f,
                      indent=1)
        prof = None

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        n_imgs = 0
        waited = train_loader.wait_s
        for batch in train_loader:
            rng = step_generator(cfg, state.step, runner.device)
            state, _ = runner.train_step(state, batch.image, batch.mask, rng)
            n_imgs += batch.image.shape[0] * mesh.data_world()  # the global batch
            if prof is not None and state.step >= profile_stop_at:
                stop_profile()
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        train_time = time.time() - t0

        f1, per_class, val_loss = runner.run_eval(val_loader)  # global: the same on every rank
        if mesh.is_main():
            _warn_nan_f1(f1, per_class, epoch, patience_left)
        if _is_improvement(f1, best_f1, ckpt_lib.checkpoint_exists(best_path)):
            if not math.isnan(f1):  # never poison best_f1 with NaN
                best_f1, best_epoch = f1, epoch
                patience_left = cfg.patience
            runner.save(best_path, epoch=epoch, best_f1=best_f1, best_epoch=best_epoch)
        else:
            patience_left -= 1
        runner.save(last_path, epoch=epoch, best_f1=best_f1, best_epoch=best_epoch)

        data = epoch_metrics(f1, val_loss, best_f1, per_class)
        data["imgs_per_sec"] = round(n_imgs / max(train_time, 1e-9), 2)
        data["loader_wait_s"] = round(train_loader.wait_s - waited, 3)
        if logger is not None:
            logger.log(epoch, data)

        if patience_left <= 0:
            _say(f"early stopping at epoch {epoch} (patience {cfg.patience})")
            break

    if prof is not None:  # run shorter than the 6-step window
        stop_profile()
    if logger is not None:
        logger.close()
    return best_path


def _first_tile_height(split_dir: str):
    """The height of the first image of a split (its header only), or None
    where the split has none yet (the loader raises then)."""
    paths = sorted(glob.glob(os.path.join(split_dir, "images", "*.png")))
    if not paths:
        return None
    with Image.open(paths[0]) as im:
        return im.size[1]


def _check_supported(cfg: Config) -> None:
    """Raise for a run the port cannot do, before any rank starts: for
    training everything :func:`_check_fit_supported` checks; under
    ``--spatial_shards`` the eval tiles' height (the validation split's in
    train mode, the holdout's in eval mode; ``Config`` checks the train
    crop)."""
    if cfg.exec_mode == "train":
        _check_fit_supported(cfg)
    if cfg.spatial_shards > 1 and cfg.data:
        split = "test" if cfg.exec_mode == "train" else "holdout"
        height = _first_tile_height(os.path.join(cfg.data, split))
        if height is not None:
            check_band_height(height, cfg.spatial_shards, f"the {split} split's tile")


def test(cfg: Config, device="cuda") -> dict:
    """Eval mode: restore the checkpoint, run the holdout, dump artifacts and
    metrics (reference main.py:113-122 eval branch).  Runs on ``device``,
    CUDA by default; under a process group of ``--gpus`` ranks, on this
    rank's rows of each global batch."""
    dev = resolve_device(device)
    mesh.check_world(cfg.gpus, cfg.spatial_shards)
    if not ckpt_lib.checkpoint_exists(cfg.ckpt):
        raise FileNotFoundError(f"no checkpoint found for evaluation at {cfg.ckpt!r}")
    # model hyperparameters come from the checkpoint; TTA and the fused tail
    # are eval-time compute knobs (identical variable trees), overridable
    saved = ckpt_lib.load_config(cfg.ckpt)
    tta = {"auto": saved.tta, "on": True, "off": False}[cfg.eval_tta]
    fused = {"auto": saved.fused_tail, "on": True, "off": False}[cfg.eval_fused_tail]
    einsum = {"auto": saved.einsum_1x1, "on": True, "off": False}[cfg.eval_einsum_1x1]
    cfg = saved.replace(exec_mode="eval", data=cfg.data, results=cfg.results,
                        gpus=cfg.gpus, spatial_shards=cfg.spatial_shards,
                        train_crop=cfg.train_crop, num_workers=cfg.num_workers,
                        val_batch_size=cfg.val_batch_size, logname=cfg.logname,
                        ckpt=cfg.ckpt, tta=tta, fold_eval_bn=cfg.fold_eval_bn,
                        fused_tail=fused, einsum_1x1=einsum)
    _check_supported(cfg)
    apply_precision(cfg)
    model = build_model(cfg)
    payload, _ = ckpt_lib.restore_raw(cfg.ckpt, ("params", "batch_stats"))
    model.load_state_dict(from_flax(payload["params"], payload["batch_stats"]), strict=True)
    model.to(dev)

    mesh.run_on_main(_clear_task_artifacts, cfg)
    loader = make_test_loader(cfg, mesh.data_rank(), mesh.data_world())
    _say(f"input decoder: {decoder_status(cfg)}")
    eval_step = make_eval_step(cfg, model, device=dev)
    f1_state = init_f1_state(cfg.n_metric_class, device=dev)
    for batch in loader:
        f1_state, _, logits = eval_step(f1_state, batch.image, batch.mask, batch.valid)
        logits = mesh.gather_rows(logits)  # the whole tiles (a no-op without a space axis)
        if mesh.space_index() == 0:
            _save_predictions(cfg, logits, batch.mask, batch.valid, batch.start)
    mesh.barrier()  # every rank's dumps are written
    f1, per_class = compute_f1(f1_state, cfg.n_metric_class)
    data = test_metrics(f1, per_class)
    if mesh.is_main():
        logger = MetricsLogger(cfg.results, cfg.logname)
        logger.log((), data)
        logger.close()
    return data
