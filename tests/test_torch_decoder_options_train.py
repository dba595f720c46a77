"""Train steps with the decoder options against the JAX package's, and the
CLI with them.

A float64 train step (``Config(precision=64)``, ``jax.enable_x64``) of
configuration D's model options (attention gates, deep supervision) with the
fused tail at 64^2, where the packed dec_l5 chain and the head take the
fused route (their plain versions here; JAX's Pallas kernels in interpret
mode): the loss over ``[out, ds4, ds3]`` with the packed loss view for the
main head and nearest-downsampled fine labels for the DS heads, every
gradient leaf and the running statistics.  ResNet-50 at the train step's
tolerances (``test_torch_train_step.py``: loss rtol 1e-9, gradients 1e-6 of
each leaf's scale, running statistics rtol 1e-9).  ResNeSt-50, D's encoder:
the loss at rtol 1e-4, and the gradients' distance printed.  Its split
attention pools in float32 in both packages, each summing in its own order,
and in a train step ``bn1`` normalizes over the batch's two pooled values,
which carries that ulp through the whole backward: measured here, the
gradients of the 2 x 64^2 step lie 1.67 apart in relative L2 (the plain
ResNeSt-50 ``UNetLoc``, no decoder option, 1.69) while the losses agree to
1.2e-5, so no gradient tolerance below the float32 noise can hold (its
modules are held in ``test_torch_resnest.py``).  A damage
variant with deep supervision, ``--dec_interp`` and CORAL (fine tail, fine
heads) is ``slow``.  The ResNet-50 step is traced once and also serves
AdamP's and NovoGrad's float64 updates from its gradients, against JAX's.
Then ``make_train_step`` with deep supervision is its augmentation, both
label views and the same loss, and the train and eval CLIs run with
``--attention --deep_supervision --ppm``."""

import json
import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch

from test_torch_train_step import _close, _flat
from torch_jax_variables import one_torch_thread, seeded_model  # noqa: F401
from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models.layers import fused_tail_scope as jax_fused_tail_scope
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu.models.unet import emits_packed_loss_view as jax_packed_view
from xview2_tpu.models.unet import fused_head_defer_ok as jax_defer_ok
from xview2_tpu.ops.layout import relayout_standard as jax_relayout
from xview2_tpu.ops.losses import deep_supervision_loss as jax_ds_loss
from xview2_tpu.ops.losses import make_loss_fn as jax_make_loss_fn
from xview2_tpu.ops.losses import packed_loss_view_labels as jax_packed_labels
from xview2_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.data.synthetic import make_synthetic_dataset
from xview2_tpu_torch.main import main
from xview2_tpu_torch.models.unet import build_model, emits_packed_loss_view
from xview2_tpu_torch.ops.augment import augment_batch
from xview2_tpu_torch.ops.losses import make_loss_fn, packed_loss_view_labels
from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
from xview2_tpu_torch.parallel import steps as port_steps
from xview2_tpu_torch.train.optimizers import build_optimizer
from xview2_tpu_torch.weights import from_flax, to_flax

D_OPTIONS = dict(attention=True, deep_supervision=True, loss_str="focal+dice")
ZOO_STEP = ("adamp", "novograd")
OPT_KW = dict(weight_decay=1e-2, lr=3e-3)


def jax_ds_grads(cfg_kw, variables, x, y, optimizers=()):
    """JAX's train-mode forward, loss and gradient of one batch, as its
    ``make_train_step`` computes them without the augmentation and the
    update: both label views relayouted when the main head emits the packed
    loss view and deep supervision is on, each output relayouted at the loss
    seam, ``deep_supervision_loss`` over the list.  Returns (loss, flat
    gradients, flat new batch_stats, {optimizer: (flat params after its
    update from those gradients, the gradients as a port ``state_dict``)}
    for each of ``optimizers``, at ``OPT_KW``'s weight decay and rate)."""
    cfg = JaxConfig(**cfg_kw)
    model = jax_build_model(cfg)
    loss_fn = jax_make_loss_fn(cfg.loss_str, cfg.type)
    packed = jax_packed_view(cfg)

    def forward_loss(p, bs, x, y, y_main):
        with jax_fused_tail_scope(bool(cfg.fused_tail), None, defer_head=jax_defer_ok(cfg)):
            outs, mutated = model.apply({"params": p, "batch_stats": bs}, x, True,
                                        mutable=["batch_stats"])
        assert isinstance(outs, list) and len(outs) == 3
        return jax_ds_loss(loss_fn, [jax_relayout(o) for o in outs], y,
                           main_labels=y_main), mutated["batch_stats"]

    @jax.jit
    def step(p, bs, x, y):
        if packed:
            y_main = jax_relayout(jax_packed_labels(y))
            y = jax_relayout(y)
        else:
            y = y_main = jax_relayout(y)
        (loss, new_bs), grads = jax.value_and_grad(forward_loss, has_aux=True)(p, bs, x, y,
                                                                               y_main)
        return loss, grads, new_bs

    loss, grads, new_bs = step(variables["params"], variables["batch_stats"], x, y)
    updated = {}
    for name in optimizers:
        tx = jax_build_optimizer(JaxConfig(**dict(cfg_kw, optimizer=name, **OPT_KW)),
                                 OPT_KW["lr"])
        upd, _ = jax.jit(tx.update)(grads, tx.init(variables["params"]), variables["params"])
        updated[name] = (_flat(optax.apply_updates(variables["params"], upd)),
                         from_flax(jax.device_get(grads), {}))
    return float(loss), _flat(grads), _flat(new_bs), updated


def _ds_step_run(kw, size=64, seed=3, kernel_scale=2.2, optimizers=()):
    """One float64 train step of ``kw`` in the port and in JAX on the same
    weights and crop, and JAX's update by each of ``optimizers``: what
    :func:`_ds_step_check` and the optimizer tests read."""
    kw = dict(kw, precision=64, fused_tail=True, optimizer="adamw")
    cfg = Config(**kw)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, size, size, cfg.in_channels))
    if cfg.type == "post":
        y = rng.integers(0, 5, (2, size, size)).astype(np.int32)
        y[0, :4, :6] = 255
    else:
        y = (rng.random((2, size, size)) > 0.7).astype(np.int32)
    model, variables = seeded_model(kw, seed=seed, kernel_scale=kernel_scale)
    with jax.enable_x64():
        jloss, jgrads, jstats, updated = jax_ds_grads(kw, variables, x, y, optimizers)
    run = dict(kw=kw, jloss=jloss, jgrads=jgrads, jstats=jstats, updated=updated,
               stats0=_flat(variables["batch_stats"]), params0=_flat(variables["params"]))
    del variables

    yt = torch.from_numpy(y)
    y_main = packed_loss_view_labels(yt) if emits_packed_loss_view(cfg) else yt
    loss = port_steps.forward_loss(cfg, model, make_loss_fn(cfg.loss_str, cfg.type),
                                   torch.from_numpy(x), y_main, yt)
    names, params = zip(*model.named_parameters())
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
    run.update(loss=loss.item(), grads=dict(zip(names, grads)),
               params={n: p.detach().clone() for n, p in zip(names, params)},
               stats=_flat(to_flax({k: v for k, v in model.state_dict().items()
                                    if "running" in k})[1]))
    return run


def _ds_step_check(run, tol):
    """The loss at rtol ``tol[0]``, every gradient leaf within ``tol[1]`` of
    its scale, the running statistics at rtol ``tol[2]``; a ``None``
    tolerance prints the distance instead (relative L2 over all leaves, the
    worst leaf's share of its scale).  Returns those."""
    kw, jloss, jgrads, jstats = run["kw"], run["jloss"], run["jgrads"], run["jstats"]
    assert run["loss"] == pytest.approx(jloss, rel=tol[0])
    got = _flat(to_flax(run["grads"])[0])
    assert set(got) == set(jgrads)
    assert any("output_block_ds3" in k for k in got) and any("output_block_ds4" in k for k in got)
    assert all(np.isfinite(v).all() for v in got.values())
    got_s = run["stats"]
    assert set(got_s) == set(jstats)
    dist = {"grad_rel_l2": float(np.sqrt(sum(((got[k] - w) ** 2).sum() for k, w in jgrads.items())
                                         / sum((w ** 2).sum() for w in jgrads.values()))),
            "grad_worst_of_scale": max(float(np.abs(got[k] - w).max() / max(np.abs(w).max(),
                                                                            1e-12))
                                       for k, w in jgrads.items()),
            "loss_rel": abs(run["loss"] - jloss) / abs(jloss)}
    print(f"train step {kw['encoder']}: {dist}")
    if tol[1] is not None:
        for key, want in jgrads.items():
            _close(got[key], want, tol[1], f"gradient {key}")
    if tol[2] is not None:
        for key, want in jstats.items():
            np.testing.assert_allclose(got_s[key], want, rtol=tol[2], atol=1e-12, err_msg=key)
            assert not np.array_equal(want, run["stats0"][key])
    return dist


def _ds_step_case(kw, tol, **run_kw):
    return _ds_step_check(_ds_step_run(kw, **run_kw), tol)


@pytest.fixture(scope="module")
def resnet50_d_step():
    """The ResNet-50 step with D's options, JAX's traced once for the step's
    test and the optimizers' (AdamP, NovoGrad) updates from its gradients."""
    return _ds_step_run(dict(type="pre", encoder="resnet50", **D_OPTIONS),
                        optimizers=ZOO_STEP)


def test_d_options_train_step_f64_matches_jax_resnet50(resnet50_d_step):
    """D's model options (attention gates on the four skips, deep
    supervision) on a ResNet-50 encoder, fused tail: the main head through
    the fused head on the deferred dec5 fold, the DS heads on the activated
    dec4 and dec3."""
    _ds_step_check(resnet50_d_step, (1e-9, 1e-6, 1e-9))


@pytest.mark.parametrize("name", ZOO_STEP)
def test_optimizer_update_of_the_step_f64_matches_jax(name, resnet50_d_step):
    """AdamP and NovoGrad on that float64 ResNet-50 ``UNetLoc`` step (whose
    gradients the step's test holds to JAX's): each updates every parameter
    from JAX's gradients as JAX's update does (optax's NovoGrad, the JAX
    package's AdamP), each leaf's movement within 1e-9 of its largest.
    AdamP takes its channel view on the flax leaf and NovoGrad one second
    moment per leaf, so a port parameter that is not one flax leaf in
    another layout would show here.  (From the port's own gradients, 1e-12
    from JAX's, AdamP's first update reads up to 1.2e-6 off on a leaf whose
    gradient is orthogonal to its weight: g / (|g| + eps) amplifies the
    gradients' last digits where |g| is near eps.)"""
    run = resnet50_d_step
    want_params, grads = run["updated"][name]
    params = {n: torch.nn.Parameter(p.clone()) for n, p in run["params"].items()}
    assert set(grads) == set(params)
    for n, p in params.items():
        p.grad = grads[n].clone()
    opt = build_optimizer(Config(**dict(run["kw"], optimizer=name, **OPT_KW)),
                          params.values(), OPT_KW["lr"])
    opt.step()
    got = _flat(to_flax({n: p.detach() for n, p in params.items()})[0])
    old = run["params0"]
    assert set(got) == set(want_params) == set(old)
    for key, want in want_params.items():
        moved = want - old[key]
        np.testing.assert_allclose(got[key] - old[key], moved, rtol=0,
                                   atol=1e-9 * max(np.abs(moved).max(), 1e-30), err_msg=key)


def test_d_train_step_f64_matches_jax_resnest50():
    """Configuration D's model itself: ResNeSt-50 with attention and deep
    supervision.  The loss at rtol 1e-4; the gradients and running
    statistics sit at the split attention's float32 noise (module
    docstring) and are printed, not held."""
    _ds_step_case(dict(type="pre", encoder="resnest50", **D_OPTIONS), (1e-4, None, None))


@pytest.mark.slow
def test_damage_variant_ds_dec_interp_coral_train_step_f64_matches_jax():
    """``fused`` with deep supervision, ``--dec_interp`` and CORAL: the last
    cross-fusion is not packed, the tail and all three heads are fine, the
    DS heads read the concat of both branches."""
    _ds_step_case(dict(type="post", dmg_model="fused", encoder="resnet50", loss_str="coral",
                       deep_supervision=True, dec_interp=True, attention=True),
                  (1e-9, 1e-6, 1e-9))


def test_train_step_with_deep_supervision_is_its_augmentation_then_the_loss():
    """``make_train_step`` with D's options: the loss equals ``forward_loss``
    on ``augment_batch`` from the same generator state with the packed loss
    view for the main head and the fine labels for the DS heads, and every
    head's parameters move."""
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (2, 96, 96, 3), np.uint8)
    masks = (rng.random((2, 96, 96)) > 0.8).astype(np.uint8)
    cfg = Config(type="pre", encoder="resnet50", precision=32, fused_tail=True, optimizer="sgd",
                 autoaugment=True, **D_OPTIONS)
    torch.manual_seed(0)
    model = build_model(cfg)
    x, y = augment_batch(port_steps.step_generator(cfg, 0, "cpu"), torch.from_numpy(images),
                         torch.from_numpy(masks), crop=64, use_autoaugment=True)
    with torch.no_grad():
        want = port_steps.forward_loss(cfg, model, make_loss_fn(cfg.loss_str, cfg.type), x,
                                       packed_loss_view_labels(y), y)
        main_only = port_steps.forward_loss(cfg, model, make_loss_fn(cfg.loss_str, cfg.type),
                                            x, packed_loss_view_labels(y), torch.zeros_like(y))
    before = {k: v.clone() for k, v in model.named_parameters()}
    opt = build_optimizer(cfg, model.parameters(), cfg.lr)
    state = port_steps.init_train_state(model, opt, device="cpu")
    step = port_steps.make_train_step(cfg, model, opt, crop=64, device="cpu")
    state, loss = step(state, images, masks, port_steps.step_generator(cfg, 0, "cpu"))
    assert loss.item() == pytest.approx(want.item(), rel=1e-6)
    assert main_only.item() != pytest.approx(want.item(), rel=1e-3)  # the DS labels count
    for head in ("output_block.output_block.", "output_block.output_block_ds3.",
                 "output_block.output_block_ds4.", ".conv_o.", ".psi."):
        assert any(head in k and not torch.equal(v, before[k])
                   for k, v in model.named_parameters()), head


@pytest.fixture(scope="module")
def options_cli(tmp_path_factory):
    """``main(--exec_mode train --attention --deep_supervision --ppm)`` on a
    tiny synthetic tree, then the eval CLI on its best checkpoint; what the
    test asserts is read here and the tree removed (checkpoints with
    optimizer state are hundreds of MB)."""
    root = str(tmp_path_factory.mktemp("xbd_options"))
    make_synthetic_dataset(root, n_train=4, n_val=2, n_test=2, size=96, seed=5)
    res, ev = os.path.join(root, "train"), os.path.join(root, "eval")
    argv = ["--exec_mode", "train", "--type", "pre", "--encoder", "resnet50", "--precision",
            "32", "--fused_tail", "1", "--batch_size", "2", "--val_batch_size", "2",
            "--num_workers", "2", "--train_crop", "64", "--epochs", "1", "--data", root,
            "--results", res, "--attention", "--deep_supervision", "--ppm"]
    out = {"train_rc": main(argv, device="cpu")}
    with open(os.path.join(res, "logs.json")) as f:
        out["train_log"] = json.loads(f.readlines()[-1])["data"]
    best = os.path.join(res, "checkpoints", "best")
    payload, meta = ckpt_lib.restore_raw(best)
    out["config"] = meta["config"]
    out["param_paths"] = {"/".join(p) for p in _paths(payload["params"])}
    out["eval_rc"] = main(["--exec_mode", "eval", "--type", "pre", "--data", root, "--results",
                           ev, "--ckpt", best, "--val_batch_size", "2", "--num_workers", "2",
                           "--eval_tta", "on"], device="cpu")
    out["probs"] = [np.load(os.path.join(ev, "probs", p))
                    for p in sorted(os.listdir(os.path.join(ev, "probs")))]
    with open(os.path.join(ev, "logs.json")) as f:
        out["eval_log"] = json.loads(f.readlines()[-1])["data"]
    shutil.rmtree(root)
    return out


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_cli_trains_and_evaluates_with_decoder_options(options_cli):
    """Both CLIs take the options: the checkpoint records them and holds the
    PPM, the gates and both DS heads; the eval dumps are the localization
    probabilities of the 96^2 tiles (the DS heads run in train mode only)."""
    out = options_cli
    assert out["train_rc"] == 0 and out["eval_rc"] == 0
    assert np.isfinite(out["train_log"]["val_loss"])
    assert all(out["config"][k] for k in ("attention", "deep_supervision", "ppm"))
    for part in ("unet/ppm/fuse/bias", "unet/ppm/reduce3/kernel",
                 "unet/dec_layers_0/psi/Conv_0/kernel", "unet/dec_layers_3/conv_s/Conv_0/kernel",
                 "output_block/output_block_ds3/conv/kernel",
                 "output_block/output_block_ds4/conv/bias"):
        assert part in out["param_paths"], part
    assert len(out["probs"]) == 2
    for p in out["probs"]:
        assert p.shape == (96, 96) and p.dtype == np.float32
        assert np.isfinite(p).all() and 0 <= p.min() and p.max() <= 1
    assert np.isfinite(out["eval_log"]["f1"])
