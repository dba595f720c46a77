"""The ranks of the data-parallel tests: real processes in one gloo group on
the CPU.  Torch only: a spawned rank imports this module, so it must never
import JAX (the JAX references run in the test process).

:func:`start` launches ``world`` processes that join one group by a file
rendezvous in the job's directory (no port to collide under pytest-xdist),
run one job of :data:`JOBS` on one thread and ``torch.save`` what it returns
to ``rank{r}.pt`` there; :func:`join` waits with a deadline, so a rank that
hangs in a collective fails the test instead of the suite.

The case functions take ``(rank, world)`` and compute on rank ``rank``'s
rows of inputs drawn whole from a numpy seed; called with ``(0, 1)`` outside
any group they give the single-process reference on the whole batch.
"""

import hashlib
import multiprocessing
import os
import time

import numpy as np
import torch

from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models import layers
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.ops.losses import deep_supervision_loss, make_loss_fn
from xview2_tpu_torch.parallel import mesh, steps
from xview2_tpu_torch.train.optimizers import build_optimizer

B = 4                 # the global batch
TILE, CROP = 48, 32   # raw tiles and the train step's crops
# SGD with momentum, as the trajectory parities take it: Adam's first update
# g / (|g| + eps) turns float64 noise of a gradient element near eps into
# 1e-9 of a leaf's scale, whatever computed the gradient
TRAIN_KW = dict(type="pre", encoder="resnet50", precision=64, loss_str="focal+dice",
                fused_tail=True, optimizer="sgd", lr=1e-2, momentum=0.9)


def rows(rank, world, b=B):
    return slice(rank * b // world, (rank + 1) * b // world)


# ------------------------------------------------------------- BatchNorm

def _bn(c, rng):
    bn = layers.BatchNorm(c).double()
    with torch.no_grad():
        for t, draw in ((bn.weight, lambda: rng.uniform(0.5, 1.5, c)),
                        (bn.bias, lambda: rng.normal(0, 0.1, c)),
                        (bn.running_mean, lambda: rng.normal(0, 0.1, c)),
                        (bn.running_var, lambda: rng.uniform(0.5, 2.0, c))):
            t.copy_(torch.from_numpy(draw()))
    return bn


def _leaf(full, sl):
    return torch.from_numpy(full[sl].copy()).requires_grad_()


def _bn_result(bn, y, x):
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def bn_cases(rank, world):
    """Each BatchNorm statistics point on the rank's rows, a local objective
    ``sum(out * cotangent)`` of the rows behind it: the output rows, the
    input gradient rows, this rank's share of the affine gradients and the
    running statistics."""
    sl, out = rows(rank, world), {}
    rng = np.random.default_rng(0)
    c = 8
    x, cot = rng.normal(1.0, 2.0, (B, 5, 6, c)), rng.normal(size=(B, 5, 6, c))
    bn, xr = _bn(c, rng), _leaf(x, sl)
    y = bn.normalize_train(xr, torch.float64)
    (y * torch.from_numpy(cot[sl])).sum().backward()
    out["normalize_train"] = _bn_result(bn, y, xr)

    x, cot = rng.normal(-0.5, 1.5, (B, 4, 4, 4 * c)), rng.normal(size=(B, 4, 4, 4 * c))
    bn, xr = _bn(c, rng), _leaf(x, sl)
    y = bn.normalize_train_packed(xr, torch.float64)
    (y * torch.from_numpy(cot[sl])).sum().backward()
    out["normalize_train_packed"] = _bn_result(bn, y, xr)

    for phases in (1, 4):  # K2's sums of a plain and of an s2d-packed chain
        x, cot = rng.normal(0.3, 1.2, (B, 4, 4, phases * c)), rng.normal(size=(B, 4, 4, phases * c))
        bn, xr = _bn(c, rng), _leaf(x, sl)
        n = xr.shape[0] * 4 * 4 * phases
        mean, mul, bias = bn.fold_from_sums(xr.sum(dim=(0, 1, 2)), (xr * xr).sum(dim=(0, 1, 2)),
                                            n, phases, True)
        y = (xr - mean) * mul + bias  # the next layer's prologue on the rank's rows
        (y * torch.from_numpy(cot[sl])).sum().backward()
        out[f"fold_from_sums_{phases}"] = _bn_result(bn, y, xr)
    return out


# ----------------------------------------------------------------- losses

LOSS_CASES = {  # name: (loss_str, task, channels, padded)
    "dice": ("dice", "pre", 2, False), "focal": ("focal", "pre", 2, False),
    "ce": ("ce", "pre", 2, False), "ohem": ("ohem", "pre", 2, False),
    "ohem_post": ("ohem", "post", 5, False), "dice_post": ("dice", "post", 5, False),
    "mse": ("mse", "post", 1, False), "coral": ("coral", "post", 3, False),
    "focal+dice_padded": ("focal+dice", "pre", 2, True),
}


def _labels(rng, task, shape):
    if task == "pre":
        return (rng.random(shape) > 0.7).astype(np.int64)
    lab = rng.integers(0, 5, shape)
    lab[0, :2, :3] = 255
    return lab


def loss_cases(rank, world):
    """Every loss term on the rank's rows: the loss (global, the same on
    every rank) and the rank's logits gradient divided by ``world`` (each
    rank seeds its own copy of the global loss, the N-fold seed that
    ``mesh.average_gradients`` divides away); ``padded`` gives the eval
    step's ``sample_valid`` with the last rank's rows all padding."""
    sl, out = rows(rank, world), {}
    for k, (name, (loss_str, task, ch, padded)) in enumerate(LOSS_CASES.items()):
        rng = np.random.default_rng(10 + k)
        logits = _leaf(rng.normal(0, 2.0, (B, 8, 8, ch)), sl)
        labels = torch.from_numpy(_labels(rng, task, (B, 8, 8))[sl])
        valid = torch.tensor([1.0, 1.0, 0.0, 0.0])[sl] if padded else None
        loss = make_loss_fn(loss_str, task)(logits, labels, sample_valid=valid)
        loss.backward()
        out[name] = {"loss": loss.detach(), "grad": logits.grad / world}
    rng = np.random.default_rng(30)
    outs = [_leaf(rng.normal(0, 2.0, (B, s, s, 2)), sl) for s in (8, 4, 2)]
    labels = torch.from_numpy(_labels(rng, "pre", (B, 8, 8))[sl])
    loss = deep_supervision_loss(make_loss_fn("focal+dice", "pre"), outs, labels)
    loss.backward()
    out["deep_supervision"] = {"loss": loss.detach(), "grad": torch.cat(
        [o.grad.reshape(o.shape[0], -1) for o in outs], dim=1) / world}
    return out


# ------------------------------------------------------------- train step

def raw_batch():
    """The global batch of raw uint8 tiles and labels."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (B, TILE, TILE, 3), np.uint8)
    masks = (rng.random((B, TILE, TILE)) > 0.8).astype(np.uint8)
    return images, masks


def flat(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def train_step(rank, world, state, remat="none", perturb=False):
    """One ``make_train_step`` on the rank's rows of :func:`raw_batch` from
    the model state ``state``, its augmentation included: the loss, the
    crops the rank trained on, the gradients after the all-reduce, the
    parameters after the update and the buffers (flat), and the folds of
    the fused chain in call order (a recomputation appends its own).
    ``perturb``: ranks other than 0 start from other weights, which
    ``mesh.broadcast_module`` must replace by rank 0's."""
    cfg = Config(**dict(TRAIN_KW, remat=remat))
    model = build_model(cfg).double()
    model.load_state_dict(state, strict=True)
    if perturb and rank:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01)
    mesh.broadcast_module(model)
    opt = build_optimizer(cfg, model.parameters(), cfg.lr)
    st = steps.init_train_state(model, opt, device="cpu")
    rec = {"folds": []}
    augment, fold_from_sums, opt_step = steps.augment_batch, layers.BatchNorm.fold_from_sums, \
        opt.step

    def augment_rec(*a, **kw):
        rec["crops"] = augment(*a, **kw)
        return rec["crops"]

    def fold_rec(self, *a):
        fold = fold_from_sums(self, *a)
        rec["folds"].append(tuple(v.detach().clone() for v in fold))
        return fold

    def step_rec(*a, **kw):
        rec["grads"] = flat(p.grad for p in model.parameters())
        return opt_step(*a, **kw)

    steps.augment_batch, layers.BatchNorm.fold_from_sums, opt.step = augment_rec, fold_rec, \
        step_rec
    try:
        images, masks = raw_batch()
        sl = rows(rank, world)
        step = steps.make_train_step(cfg, model, opt, crop=CROP, device="cpu")
        before = mesh.collective.calls
        st, loss = step(st, images[sl], masks[sl], steps.step_generator(cfg, 0, "cpu"))
        rec["collectives"] = mesh.collective.calls - before
    finally:
        steps.augment_batch, layers.BatchNorm.fold_from_sums = augment, fold_from_sums
    rec.update(loss=loss, params=flat(model.parameters()), buffers=flat(model.buffers()))
    return rec


def train_job(rank, world, state_path):
    """The train step without remat (with rank 0's weights broadcast over
    perturbed ones), then under ``--remat full``, compared here (EQUAL);
    rank 0 returns its gradients and parameters, every rank their digests."""
    state = torch.load(state_path)
    plain = train_step(rank, world, state, perturb=True)
    full = train_step(rank, world, state, remat="full")
    n = len(plain["folds"])
    recomputed = full["folds"][n:]
    out = {"loss": plain["loss"], "crops": plain["crops"], "buffers": plain["buffers"],
           "collectives": plain["collectives"], "n_folds": n,
           "digest": digest(torch.cat([plain["params"], plain["buffers"]])),
           "remat": {"loss": torch.equal(full["loss"], plain["loss"]),
                     "params": torch.equal(full["params"], plain["params"]),
                     "buffers": torch.equal(full["buffers"], plain["buffers"]),
                     "n_folds": len(full["folds"]),
                     "first_folds": all(torch.equal(a, b) for fa, fb in
                                        zip(plain["folds"], full["folds"][:n])
                                        for a, b in zip(fa, fb)),
                     "recomputed_folds": len(recomputed) == n and all(
                         torch.equal(a, b) for fa, fb in zip(full["folds"][:n], recomputed)
                         for a, b in zip(fa, fb))}}
    if rank == 0:
        out.update(grads=plain["grads"], params=plain["params"])
    return out


def all_cases_job(rank, world, state_path):
    return {"bn": bn_cases(rank, world), "loss": loss_cases(rank, world),
            "train": train_job(rank, world, state_path)}


def fold_on_card_job(rank, world):
    """K2's sums on the card (one device, both ranks) through
    ``fold_from_sums`` over gloo: the fold and the running statistics."""
    from xview2_tpu_torch.ops.packed_fused_conv import conv_bn_fused

    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (4, 16, 64, 128)).astype(np.float32)
    k = rng.normal(0, 0.05, (3, 3, 128, 128)).astype(np.float32)
    sl = rows(rank, world)
    dev = torch.device("cuda")
    xr = torch.from_numpy(x[sl]).to(dev, torch.bfloat16)
    _, s1, s2 = conv_bn_fused(xr, torch.from_numpy(k).to(dev, torch.bfloat16), None, False)
    bn = layers.BatchNorm(128).to(dev)
    with torch.no_grad():
        fold = bn.fold_from_sums(s1, s2, xr.shape[0] * 16 * 64, 1, True)
    return {"fold": [v.cpu() for v in fold], "running_mean": bn.running_mean.cpu(),
            "running_var": bn.running_var.cpu(), "launches": conv_bn_fused.launches}


JOBS = {"all_cases": all_cases_job, "fold_on_card": fold_on_card_job}


def _rank_main(job, rank, world, out_dir, args):
    torch.set_num_threads(1)
    mesh.init_data_parallel(world, rank, backend="gloo", device="cpu",
                            init_method=f"file://{os.path.join(out_dir, 'rendezvous')}")
    try:
        torch.save(JOBS[job](rank, world, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


def start(job, world, out_dir, *args):
    """Start the ranks of ``job``; returns their processes."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(job, r, world, str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs, out_dir, timeout=300.0):
    """Wait for the ranks (killing them all at the deadline) and return
    what each wrote, by rank; raise if a rank failed or hung."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10.0)
    if hung:
        raise TimeoutError(f"{len(hung)} of {len(procs)} ranks still running after {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with {codes}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(len(procs))]
