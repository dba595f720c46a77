"""The ranks of the ``--spatial_shards`` tests: real processes in one gloo
group on the CPU, ``S`` space ranks per data row.  Torch only: a spawned rank
imports this module, so it must never import JAX (the JAX references run in
the test process).

:func:`start` launches ``world`` processes that join one group with space
groups of ``space`` ranks (file rendezvous in the job's directory), run one
job of :data:`JOBS` and ``torch.save`` what it returns; the data-parallel
jobs' :func:`join` waits for them with a deadline.

The case functions compute on this rank's band of the rows (``mesh.band``)
of inputs drawn whole from a numpy seed; called outside any group they give
the single-process reference on the whole height.
"""

import contextlib
import gc
import hashlib
import multiprocessing
import os

import numpy as np
import torch

import torch_data_parallel_jobs as dp_jobs
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models import layers
from xview2_tpu_torch.models.resnest import SplAtConv2d, avg_pool_torch
from xview2_tpu_torch.models.resnet import max_pool_3x3_s2
from xview2_tpu_torch.models.unet import build_model, emits_packed_loss_view
from xview2_tpu_torch.ops.layout import relayout_standard
from xview2_tpu_torch.ops.losses import make_loss_fn, packed_loss_view_labels
from xview2_tpu_torch.ops.metrics import init_f1_state
from xview2_tpu_torch.parallel import mesh, steps
from xview2_tpu_torch.train.optimizers import build_optimizer

join = dp_jobs.join
digest = dp_jobs.digest
flat = dp_jobs.flat

TILE, CROP = 128, 64  # raw and eval tiles, train crops: multiples of 32 * S at S = 2
B = 2                 # the global batch of the 1 x 2 train step
TRAIN_KW = dict(dp_jobs.TRAIN_KW)
# the Siamese --autoaugment step of tests/test_spatial.py, in float64
SIAMESE_KW = dict(type="post", dmg_model="siamese", encoder="resnet50", precision=64,
                  loss_str="focal+dice", autoaugment=True, fused_tail=True, optimizer="sgd",
                  lr=1e-2, momentum=0.9)
EVAL_KW = dict(TRAIN_KW, tta=True)
RESNEST_KW = dict(TRAIN_KW, encoder="resnest50")


def _leaf(full):
    """This rank's band of a whole-height numpy array, as a leaf."""
    return mesh.band(torch.from_numpy(full)).clone().requires_grad_()


def _conv(k, stride, padding, dilation, cin=6, cout=8, h=16, groups=1):
    def run(rng):
        x = rng.normal(size=(2, h, 12, cin))
        w = torch.from_numpy(rng.normal(size=(cout, cin // groups, k, k)) / k).requires_grad_()
        xb = _leaf(x)
        out = layers.conv_nhwc(xb, w, stride=stride, padding=padding, dilation=dilation,
                               groups=groups)
        return out, [xb], [w]
    return run


def _max_pool(rng):
    xb = _leaf(rng.normal(size=(2, 16, 10, 4)))
    return max_pool_3x3_s2(xb), [xb], []


def _avg_pool(window, stride, padding, ceil_mode=False, count_include_pad=True):
    def run(rng):
        xb = _leaf(rng.normal(size=(2, 16, 10, 4)))
        return avg_pool_torch(xb, window, stride, padding, ceil_mode, count_include_pad), [xb], []
    return run


def _split_attention(train):
    def run(rng):
        m = SplAtConv2d(8, 8, dtype=torch.float64).double()
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.from_numpy(rng.normal(0.0, 0.3, p.shape)))
            m.bn1.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(3))
        xb = _leaf(rng.normal(size=(3, 16, 10, 8)))
        out = m(xb, train)
        buffers = [m.bn0.running_mean, m.bn0.running_var, m.bn1.running_mean,
                   m.bn1.running_var]
        return out, [xb], list(m.parameters()), buffers
    return run


def _conv_bn_band(rng):
    """The fused chain's conv on a band (``layers.conv_bn_band``, K2's plain
    version here) with a fold: ``out``, the local ``s1``/``s2``, and the
    gradients of the input, the kernel and the fold."""
    c, co = 8, 16
    xb = _leaf(rng.normal(0.3, 1.2, (2, 8, 6, c)))
    k = torch.from_numpy(rng.normal(0, 0.2, (3, 3, c, co))).requires_grad_()
    fold = [torch.from_numpy(v).requires_grad_() for v in
            (rng.normal(0, 0.2, c), rng.uniform(0.5, 1.5, c), rng.normal(0, 0.1, c))]
    out, s1, s2 = layers.conv_bn_band(xb, k, tuple(fold), True)
    return (out, s1, s2), [xb], [k, *fold]


PRIMITIVES = {
    "conv_7x7_s2_p3": _conv(7, 2, 3, 1, cin=3),
    "conv_3x3_s2_p1": _conv(3, 2, 1, 1),
    "conv_3x3_dilation2": _conv(3, 1, 2, 2),
    "conv_3x3_grouped": _conv(3, 1, 1, 1, groups=2),
    "conv_1x1_s2": _conv(1, 2, 0, 1),
    "conv_deeper_than_band": _conv(3, 1, 4, 4, h=4),
    "max_pool_3x3_s2": _max_pool,
    "avd_pool_3x3_s2": _avg_pool(3, 2, 1),
    "avd_pool_3x3_s1": _avg_pool(3, 1, 1),
    "avg_down_pool_2x2": _avg_pool(2, 2, 0, ceil_mode=True, count_include_pad=False),
    "split_attention_train": _split_attention(True),
    "split_attention_eval": _split_attention(False),
    "conv_bn_band": _conv_bn_band,
}

LOSSES = {"ohem": ("ohem", "pre", 2), "focal+dice": ("focal+dice", "pre", 2),
          "ce": ("ce", "pre", 2), "ohem_post": ("ohem+dice", "post", 5),
          "coral": ("coral", "post", 3), "mse": ("mse", "post", 1)}


def primitive_cases():
    """Every primitive on this rank's band of a float64 input, with the
    local objective ``sum(out * cotangent)`` over the band: the output band,
    the input gradient band, this rank's share of the parameter gradients
    and the buffers after the call."""
    res = {}
    for i, (name, run) in enumerate(PRIMITIVES.items()):
        rng = np.random.default_rng(100 + i)
        got = run(rng)
        outs, inputs, params = got[:3]
        buffers = got[3] if len(got) > 3 else []
        outs = outs if isinstance(outs, tuple) else (outs,)
        crng = np.random.default_rng(200 + i)
        total = 0.0
        for o in outs:
            full_h = o.shape[1] * mesh.space_shards() if o.dim() == 4 else None
            if full_h is None:  # a per-channel sum: the rank's own part
                cot = torch.from_numpy(crng.normal(size=o.shape))
            else:
                cot = mesh.band(torch.from_numpy(crng.normal(size=(o.shape[0], full_h) +
                                                             tuple(o.shape[2:]))))
            total = total + (o * cot).sum()
        total.backward()
        res[name] = {"outs": [o.detach() for o in outs], "dx": [x.grad for x in inputs],
                     "dparams": [p.grad for p in params],
                     "buffers": [b.clone() for b in buffers]}
    for i, (name, (loss_str, task, ch)) in enumerate(LOSSES.items()):
        rng = np.random.default_rng(300 + i)
        logits = _leaf(rng.normal(0, 2.0, (2, 16, 8, ch)))
        labels = rng.integers(0, 5, (2, 16, 8)) if task == "post" else \
            (rng.random((2, 16, 8)) > 0.7).astype(np.int64)
        loss = make_loss_fn(loss_str, task)(logits, mesh.band(torch.from_numpy(labels)))
        loss.backward()
        # each rank seeds its own copy of the global loss: divide the S-fold seed
        res[f"loss_{name}"] = {"loss": loss.detach(),
                               "grad": logits.grad / mesh.world_size()}
    return res


# ------------------------------------------------------------- model steps

def raw_batch(b=B, channels=3, seed=5, tile=TILE):
    """The global batch of raw uint8 tiles and labels."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, tile, tile, channels), np.uint8)
    masks = (rng.random((b, tile, tile)) > 0.8).astype(np.uint8)
    if channels == 6:
        masks = masks * rng.integers(1, 5, masks.shape).astype(np.uint8)
    return images, masks


def data_rows(b):
    """This rank's data row's slice of a global batch of ``b``."""
    d, n = mesh.data_rank(), mesh.data_world()
    return slice(d * b // n, (d + 1) * b // n)


# more eval steps (one tile, no TTA): the stock tail, ResNeSt-50 (deep stem,
# split attention, avd and avg-down pools) and ResNet-50 at --dilation 4
EVAL_CASES = {"stock_tail": dict(EVAL_KW, fused_tail=False, tta=False),
              "resnest50": dict(EVAL_KW, encoder="resnest50", tta=False),
              "dilation4": dict(EVAL_KW, dilation=4, tta=False)}


def seeded_model(kw, seed=0):
    """A float64 model of ``kw`` from torch's initializers under ``seed``,
    its BatchNorm statistics and affines drawn away from the identity: the
    same in every process."""
    torch.manual_seed(seed)
    model = build_model(Config(**kw)).double()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var") or (name.endswith("weight") and t.dim() == 1):
                t.copy_(torch.rand(t.shape, generator=gen, dtype=t.dtype) + 0.5)
            elif name.endswith("running_mean") or name.endswith("bias"):
                t.copy_(torch.randn(t.shape, generator=gen, dtype=t.dtype) * 0.1)
    return model


def seeded_state(kw, seed=0):
    return seeded_model(kw, seed).state_dict()


def eval_step(state, kw=EVAL_KW, b=1, channels=3, mask_size=None, tile=TILE):
    """The eval step (TTA and the fused tail in ``EVAL_KW``) on the data
    row's tiles of ``tile``^2: this rank's band of the logits, the loss and
    the F1 counts.  ``mask_size``: masks of another size than the tiles
    (the ``--interpolate`` head's fixed 1024^2)."""
    cfg = Config(**kw)
    model = build_model(cfg).double()
    model.load_state_dict(state, strict=True)
    images, masks = raw_batch(b, channels, tile=tile)
    images, masks = images[:b], masks[:b]
    if mask_size is not None:
        rep = mask_size // tile
        masks = masks.repeat(rep, axis=1).repeat(rep, axis=2)
    sl = data_rows(b)
    step = steps.make_eval_step(cfg, model, device="cpu")
    f1, loss, logits = step(init_f1_state(cfg.n_metric_class), images[sl], masks[sl],
                            np.ones((b,), np.float32)[sl])
    return {"logits": logits, "loss": loss, "f1": [t.clone() for t in f1]}


def _grads(model):
    """The gradients, flat; zeros for a parameter the loss never reads."""
    return flat(torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters())


def train_step(state, kw=TRAIN_KW, b=B, channels=3, crop=CROP):
    """One ``make_train_step`` on the data row's tiles of :func:`raw_batch`,
    augmentation included: the loss, the data row's whole crops, the
    gradients after the all-reduce, the parameters after the update, the
    buffers (flat) and the collectives it sent (the space group's among
    them)."""
    cfg = Config(**dict(kw, train_crop=crop))
    model = build_model(cfg).double()
    model.load_state_dict(state, strict=True)
    opt = build_optimizer(cfg, model.parameters(), cfg.lr)
    st = steps.init_train_state(model, opt, device="cpu")
    rec = {}
    augment, opt_step = steps.augment_batch, opt.step

    def augment_rec(*a, **kw):
        rec["crops"] = augment(*a, **kw)
        return rec["crops"]

    def step_rec(*a, **kw):
        rec["grads"] = _grads(model)
        return opt_step(*a, **kw)

    steps.augment_batch, opt.step = augment_rec, step_rec
    try:
        images, masks = raw_batch(b, channels)
        sl = data_rows(b)
        step = steps.make_train_step(cfg, model, opt, crop=crop, device="cpu")
        calls, space_calls = mesh.collective.calls, mesh.collective.space_calls
        st, loss = step(st, images[sl], masks[sl], steps.step_generator(cfg, 0, "cpu"))
        rec["collectives"] = mesh.collective.calls - calls
        rec["space_collectives"] = mesh.collective.space_calls - space_calls
    finally:
        steps.augment_batch = augment
    rec.update(loss=loss, params=flat(model.parameters()), buffers=flat(model.buffers()))
    rec["digest"] = digest(torch.cat([rec["params"], rec["buffers"]]))
    return rec


def more_eval_steps():
    return {name: eval_step(seeded_state(kw), kw) for name, kw in EVAL_CASES.items()}


def unet_job(state_path):
    state = torch.load(state_path)
    return {"primitives": primitive_cases(), "eval": eval_step(state),
            "more_eval": more_eval_steps(), "train": train_step(state)}


def resnest_job():
    return train_step(seeded_state(RESNEST_KW), RESNEST_KW)


def siamese_job(state_path):
    out = train_step(torch.load(state_path), SIAMESE_KW, b=2, channels=6)
    if mesh.rank() != 0:
        for k in ("grads", "params"):
            out.pop(k)
    return out


# ------------------------------------------- every other option on the bands
# The resizes and pools of the decoder options on a band: this rank's band of
# the WHOLE height's resize (align-corners positions that fall between two
# bands, 1 -> n and n -> 1), the pools' whole map on every rank of the space
# group, and an ASPP branch whose halo is deeper than the image (the gather
# path of ``halo_rows``).  Each returns (the band's output, the band's input
# leaves, the whole-input leaves every rank holds, parameters, what every
# rank must hold whole).

def _resize(h, out_h, w=6, out_w=9):
    def run(rng):
        xb = _leaf(rng.normal(size=(2, h, w, 3)))
        return layers.interpolate_bilinear(xb, (out_h, out_w)), [xb], [], [], []
    return run


def _resize_whole(h, out_h, w=3, out_w=5):
    def run(rng):
        x = torch.from_numpy(rng.normal(size=(2, h, w, 3))).requires_grad_()
        return layers.interpolate_bilinear(x, (out_h, out_w), whole_in=True), [], [x], [], []
    return run


def _pool_and_back(h, bins, w=6):
    """PPM's branch without its conv: the band pooled to ``bins`` (whole on
    every rank), resized back to the band."""
    def run(rng):
        xb = _leaf(rng.normal(size=(2, h, w, 4)))
        pooled = layers.adaptive_avg_pool(xb, (bins, bins))
        out = layers.interpolate_bilinear(pooled, (h, w), whole_in=True)
        return out, [xb], [], [], [pooled.detach()]
    return run


def _aspp_branch(rng):
    m = layers.ASPPModule(8, 4, 3, 18, torch.float64).double()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.normal(0.5, 0.3, p.shape)))
    xb = _leaf(rng.normal(size=(2, 8, 5, 8)))
    return m(xb, True), [xb], [], list(m.parameters()), [m.BatchNorm_0.running_mean.clone(),
                                                       m.BatchNorm_0.running_var.clone()]


RESAMPLE = {
    "resize_2x_fractional_edge": _resize(16, 32),
    "resize_4_to_24": _resize(4, 24),
    "resize_16_to_4": _resize(16, 4),
    "resize_whole_1_to_16": _resize_whole(1, 16),
    "resize_whole_3_to_8": _resize_whole(3, 8),
    "pool_16_to_1_and_back": _pool_and_back(16, 1),
    "pool_16_to_3_and_back": _pool_and_back(16, 3),
    "pool_4_to_6_and_back": _pool_and_back(4, 6),
    "aspp_branch_dilation_18": _aspp_branch,
}


def resample_cases():
    """Every case of :data:`RESAMPLE` with the local objective ``sum(out *
    cotangent)`` over the band: the output band, the gradients of the band's
    input, this rank's copy's gradient of a whole input and of the
    parameters, and what every rank holds whole."""
    res = {}
    for i, (name, run) in enumerate(RESAMPLE.items()):
        out, bands, wholes, params, held = run(np.random.default_rng(700 + i))
        full = (out.shape[0], out.shape[1] * mesh.space_shards()) + tuple(out.shape[2:])
        cot = mesh.band(torch.from_numpy(np.random.default_rng(800 + i).normal(size=full)))
        (out * cot).sum().backward()
        res[name] = {"out": out.detach(), "dx": [x.grad for x in bands],
                     "dwhole": [x.grad for x in wholes], "dparams": [p.grad for p in params],
                     "held": held}
    return res


# (model options, crop): the train step from :func:`train_step` and, except
# under --remat, the TTA eval step on one tile of the crop's size from
# :func:`eval_step`, on a seeded float64 ResNet-50 model; 128^2 crops where a
# window or a resize crosses a band edge at /32, 64^2 elsewhere.
# ``ppm_attention_ds`` is also held against JAX's unsharded step (its
# unsharded reference runs in the test process, beside JAX's).
POST = dict(type="post", loss_str="focal+dice")
OPTION_CASES = {
    "ppm": (dict(ppm=True), 128),
    "ppm_attention_ds": (dict(ppm=True, attention=True, deep_supervision=True), 128),
    "parallelEnc_ppm": (dict(POST, dmg_model="parallelEnc", ppm=True), 64),
    "remat_tail": (dict(remat="tail"), 64),
    "aspp_dilation2": (dict(aspp=True, dilation=2), 128),
    "dec_interp": (dict(dec_interp=True), 128),
    "siameseEnc": (dict(POST, dmg_model="siameseEnc", loss_str="ohem+dice"), 64),
    "parallel": (dict(POST, dmg_model="parallel", loss_str="coral"), 64),
    "diff": (dict(POST, dmg_model="diff", loss_str="ohem+dice"), 64),
    "cat_mse": (dict(POST, dmg_model="cat", loss_str="mse"), 64),
    "remat_dots": (dict(remat="dots"), 64),
    "remat_full": (dict(remat="full"), 64),
}
# (model options, input size, label size): the train step's forward, loss,
# backward and gradient average (:func:`grad_step`) on a float64 batch.  The
# --interpolate head emits a fixed 512^2 in train mode (labels of 512^2
# beside a 128^2 input; its TTA eval step takes 1024^2 masks); the fused
# variants hold 300 M parameters at ResNet-50, 2.4 GB in float64, which an
# optimizer state would double.
GRAD_CASES = {"fused_coral": (dict(POST, dmg_model="fused", loss_str="coral"), 64, 64),
              "interpolate": (dict(interpolate=True), 128, 512),
              "fusedEnc_mse": (dict(POST, dmg_model="fusedEnc", loss_str="mse"), 64, 64)}
JAX_CASE = "ppm_attention_ds"


def option_kw(name):
    return dict(TRAIN_KW, **{**OPTION_CASES, **GRAD_CASES}[name][0])


@contextlib.contextmanager
def alone():
    """This process as one process without a group: every collective of
    ``mesh`` the identity (the unsharded reference, in a rank)."""
    active = mesh._ACTIVE
    mesh._ACTIVE = None
    try:
        yield
    finally:
        mesh._ACTIVE = active


def grad_batch(kw, size, label_size, seed=9):
    """A whole float64 batch of B inputs and labels."""
    cfg = Config(**kw)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, size, size, cfg.in_channels))
    if cfg.type == "post":
        y = rng.integers(0, 5, (B, label_size, label_size))
    else:
        y = (rng.random((B, label_size, label_size)) > 0.7).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(y)


def grad_step(model, kw, size, label_size):
    """The train step's forward, loss and backward of ``model`` on this
    rank's band of :func:`grad_batch` (its labels in the views the train
    step gives them) and the gradient average: the loss, the gradients (one
    tensor a parameter, taken off the model), the buffers (flat) and the
    space collectives sent."""
    cfg = Config(**kw)
    x, y = (mesh.band(t) for t in grad_batch(kw, size, label_size))
    if emits_packed_loss_view(cfg):
        y_main = relayout_standard(packed_loss_view_labels(y))
        y = relayout_standard(y) if cfg.deep_supervision else y_main
    else:
        y = y_main = relayout_standard(y)
    calls = mesh.collective.space_calls
    loss = steps.forward_loss(cfg, model, make_loss_fn(cfg.loss_str, cfg.type), x, y_main, y)
    loss.backward()
    mesh.average_gradients(model.parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return {"loss": loss.detach(), "grads": grads, "buffers": flat(model.buffers()),
            "space_collectives": mesh.collective.space_calls - calls}


def leaf_errors(got, want, names, floor_share=1e-3):
    """Each parameter's largest difference between two lists of per-leaf
    tensors, as a share of that leaf's largest magnitude in ``want`` (at
    least ``floor_share`` of the largest over all leaves: a leaf whose true
    gradient is zero, a bias that a train-mode BatchNorm cancels, holds
    float64 noise); the worst share and the leaf it sits at."""
    floor = floor_share * max(float(w.abs().max()) for w in want)
    worst, where = 0.0, None
    for name, a, b in zip(names, got, want):
        e = float((a - b).abs().max()) / max(float(b.abs().max()), floor, 1e-300)
        if e >= worst:
            worst, where = e, name
    return worst, where


def _rel(got, want):
    """Largest difference as a share of ``want``'s largest magnitude."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)


def _names_and_split(kw, vec):
    """The parameter names of the model of ``kw`` and ``vec`` (flat, in the
    parameters' order) cut into them."""
    with torch.device("meta"):
        params = list(build_model(Config(**kw)).named_parameters())
    return [n for n, _ in params], list(torch.split(vec, [p.numel() for _, p in params]))


def _digest_of(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# rough seconds of a case's unsharded reference on one CPU thread, to share
# the references out between the ranks
REF_SECONDS = {"fused_coral": 17, "fusedEnc_mse": 15, "parallelEnc_ppm": 12, "parallel": 12,
               "siameseEnc": 10, "ppm": 10, "aspp_dilation2": 10, "dec_interp": 10}


def _option_steps(name, state):
    """The train step of a case of :data:`OPTION_CASES` from ``state`` and,
    except under --remat, its TTA eval step (in or out of the group)."""
    _, crop = OPTION_CASES[name]
    kw = option_kw(name)
    channels = Config(**kw).in_channels
    out = {"train": train_step(state, kw, channels=channels, crop=crop)}
    if kw.get("remat", "none") == "none":
        out["eval"] = eval_step(state, dict(kw, tta=True), channels=channels, tile=crop)
    return out


def _grad_steps(name, model):
    """The gradient step of a case of :data:`GRAD_CASES` on ``model``, its
    running statistics put back after it; ``--interpolate`` also its TTA
    eval step on 1024^2 masks."""
    _, size, label_size = GRAD_CASES[name]
    kw = option_kw(name)
    buffers0 = [t.clone() for t in model.buffers()]
    out = {"train": grad_step(model, kw, size, label_size)}
    with torch.no_grad():
        for t, t0 in zip(model.buffers(), buffers0):
            t.copy_(t0)
    if name == "interpolate":
        out["eval"] = eval_step(model.state_dict(), dict(kw, tta=True), mask_size=1024)
    return out


def _case_steps(name, state_or_model):
    steps_fn = _grad_steps if name in GRAD_CASES else _option_steps
    return steps_fn(name, state_or_model)


def _initial(name):
    """What a case's steps start from: the seeded model (a gradient case) or
    its state (a train step builds its own model)."""
    kw = option_kw(name)
    return seeded_model(kw) if name in GRAD_CASES else seeded_state(kw)


def _distances(name, band, ref):
    """The band's distances from the unsharded reference: the loss, the worst
    gradient leaf and the buffers as shares of their scale, the crops equal,
    the eval step's logits, loss and F1 counts (the band's gathered)."""
    kw = option_kw(name)
    got, want = band["train"]["grads"], ref["train"]["grads"]
    if name in GRAD_CASES:
        with torch.device("meta"):
            names = [n for n, _ in build_model(Config(**kw)).named_parameters()]
    else:
        names, got = _names_and_split(kw, got)
        want = _names_and_split(kw, want)[1]
    out = {"ref_loss": ref["train"]["loss"], "grad_err": leaf_errors(got, want, names),
           "buffer_err": _rel(band["train"]["buffers"], ref["train"]["buffers"])}
    if "crops" in band["train"]:
        out["crops_equal"] = all(torch.equal(a, b) for a, b in zip(band["train"]["crops"],
                                                                    ref["train"]["crops"]))
    if "eval" in ref:
        out["eval_ref"] = ref["eval"]
    return out


def options_job(out_dir, names, resample):
    """The cases ``names`` of :data:`GRAD_CASES` and :data:`OPTION_CASES`.
    First each rank computes its share of the unsharded references alone
    (no group; shared out by :data:`REF_SECONDS`, longest first), then both
    run every case on their bands in order, and the rank that holds a
    case's reference adds the distances from it; each case's results go to
    ``{case}_rank{r}.pt`` in ``out_dir`` as soon as they are done: the loss,
    the collectives, a digest of the gradients (or of the parameters and
    buffers after the update), the eval step's logits gathered, and for the
    JAX case (whose reference the test process computes) on rank 0 its
    gradients, buffers and crops.  With ``resample`` the
    resize and pool cases.  Returns those and the cases' names."""
    load = [0.0] * mesh.world_size()
    owner = {}  # the JAX case's reference runs in the test process, beside JAX's step
    for name in sorted((n for n in names if n != JAX_CASE), key=lambda n: -REF_SECONDS.get(n, 5)):
        owner[name] = load.index(min(load))
        load[owner[name]] += REF_SECONDS.get(name, 5)
    refs, rank = {}, mesh.rank()
    with alone():
        for name in names:
            if owner.get(name) == rank:
                refs[name] = _case_steps(name, _initial(name))
                gc.collect()
    for name in names:
        band = _case_steps(name, _initial(name))
        train = band["train"]
        out = {"loss": train["loss"], "space_collectives": train["space_collectives"],
               "collectives": train.get("collectives"),
               "digest": train["digest"] if "digest" in train else _digest_of(train["grads"])}
        if "eval" in band:
            out["eval"] = dict(band["eval"], logits=mesh.gather_rows(band["eval"]["logits"]))
        if name == JAX_CASE and mesh.rank() == 0:
            out["train"] = {k: train[k] for k in ("grads", "buffers", "crops")}
        if name in refs:
            out.update(_distances(name, band, refs.pop(name)))
        torch.save(out, os.path.join(out_dir, f"{name}_rank{mesh.rank()}.pt"))
        del band, train, out
        gc.collect()
    return {"names": list(names), "resample": resample_cases() if resample else None}


JOBS = {"unet": unet_job, "siamese": siamese_job, "resnest": resnest_job,
        "options": options_job}


def _rank_main(job, rank, world, space, out_dir, args):
    torch.set_num_threads(1)
    mesh.init_data_parallel(world, rank, backend="gloo", device="cpu", space=space,
                            init_method=f"file://{os.path.join(out_dir, 'rendezvous')}")
    try:
        torch.save(JOBS[job](*args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


def start(job, world, space, out_dir, *args):
    """Start the ranks of ``job`` (``world`` ranks, space groups of
    ``space``); returns their processes."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(job, r, world, space, str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs
