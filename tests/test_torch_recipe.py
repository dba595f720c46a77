"""The reference's training recipe in the port, against the JAX package:

* the port's weight converter writes the ``.npz`` of the JAX package's
  ``tools/convert_weights.py`` array for array, from fabricated ResNet-50
  and ResNeSt-50 release state dicts;
* ``--pretrained_enc`` grafts into ``UNetLoc``, ``siamese`` and ``cat`` what
  JAX's trainer grafts (the 6-channel ``cat`` stem skipped), tensor for
  tensor;
* ``--fold_eval_bn 0``: every stock BatchNorm call site in eval mode (the
  ResNet and ResNeSt blocks and stems, ``ConvLayer``, ``AttentionLayer``,
  PPM, ASPP) against JAX's stock ``TorchBatchNorm`` in float64 at 1e-12
  (1e-6 through ResNeSt's float32 split-attention pool), and the whole eval
  step at ``precision=32`` against JAX's;
* ``--remat tail/dots/full`` against ``none`` in float64: the loss, every
  gradient and the running statistics EQUAL (``tail`` against the stock
  tail it runs on), the statistics updated once, and the fused kernels'
  outputs in the recomputation equal to the first forward's.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_weights import convert_resnest, convert_resnet  # noqa: E402
from convert_weights import save_npz as jax_save_npz  # noqa: E402

from test_pretrained import fabricate_resnet50_sd  # noqa: E402
from torch_jax_variables import (center_head, eval_batch, jax_variables,  # noqa: E402,F401
                                 one_torch_thread, seeded_model)
from xview2_tpu.config import Config as JaxConfig  # noqa: E402
from xview2_tpu.models import layers as jl  # noqa: E402
from xview2_tpu.models import resnest as jrs  # noqa: E402
from xview2_tpu.models import resnet as jrn  # noqa: E402
from xview2_tpu.models.pretrained import load_encoder_npz as jax_load_encoder_npz  # noqa: E402
from xview2_tpu.models.unet import build_model as jax_build_model  # noqa: E402
from xview2_tpu.ops.metrics import init_f1_state as jax_init_f1  # noqa: E402
from xview2_tpu.parallel.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from xview2_tpu.parallel.transplant import transplant_collection  # noqa: E402
from xview2_tpu_torch.config import Config  # noqa: E402
from xview2_tpu_torch.models import layers, resnest, resnet  # noqa: E402
from xview2_tpu_torch.models.convert_weights import main as convert_main  # noqa: E402
from xview2_tpu_torch.models.convert_weights import release_key  # noqa: E402
from xview2_tpu_torch.models.pretrained import apply_pretrained_encoder, encoder_state  # noqa: E402
from xview2_tpu_torch.models.unet import build_model  # noqa: E402
from xview2_tpu_torch.ops import packed_fused_conv as pfc  # noqa: E402
from xview2_tpu_torch.ops.layout import relayout_standard  # noqa: E402
from xview2_tpu_torch.ops.losses import make_loss_fn, packed_loss_view_labels  # noqa: E402
from xview2_tpu_torch.ops.metrics import init_f1_state  # noqa: E402
from xview2_tpu_torch.parallel import steps  # noqa: E402
from xview2_tpu_torch.weights import from_flax, to_flax  # noqa: E402


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def release_state_dict(arch, seed):
    """A release-shaped ``.pth`` state dict of ``arch`` drawn from ``seed``."""
    with torch.device("meta"):
        model = build_model(Config(type="pre", encoder=arch))
    rng = np.random.default_rng(seed)
    return {release_key(k[len("unet."):], arch):
            (rng.uniform(0.5, 1.5, t.shape) if k.endswith("running_var")
             else rng.normal(0, 0.1, t.shape)).astype(np.float32)
            for k, t in model.state_dict().items() if k.startswith("unet.enc_l")}


# ------------------------------------------------------------ the converter

@pytest.mark.parametrize("arch", ["resnet50", "resnest50"])
def test_converter_writes_the_jax_tools_npz(arch, tmp_path):
    sd = release_state_dict(arch, 0)
    if arch == "resnet50":  # the release's own key set, fabricated independently
        assert set(sd) == set(fabricate_resnet50_sd())
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "enc.pth")
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    assert convert_main(["--arch", arch, "--pth", str(tmp_path / "enc.pth"), "--out", ours]) == 0
    convert = convert_resnest if arch.startswith("resnest") else convert_resnet
    jax_save_npz(theirs, *convert(sd, arch))
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # every encoder tensor of the port's model comes from the file
    with torch.device("meta"):
        want = {k for k in build_model(Config(type="pre", encoder=arch)).state_dict()
                if k.startswith("unet.enc_l")}
    assert set(encoder_state(ours)) == want


# ------------------------------------------------------------ --pretrained_enc

@pytest.mark.parametrize("kind", ["pre", "siamese", "cat"])
def test_pretrained_enc_grafts_what_the_jax_trainer_grafts(kind, tmp_path):
    npz = str(tmp_path / "enc.npz")
    jax_save_npz(npz, *convert_resnet(release_state_dict("resnet50", 1), "resnet50"))
    kw = dict(encoder="resnet50", precision=32,
              **(dict(type="pre") if kind == "pre" else dict(type="post", dmg_model=kind)))
    model, variables = seeded_model(kw)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    variant = "siamese" if kind == "pre" else kind  # as JAX's trainer.py:175
    pre_p, pre_s = jax_load_encoder_npz(npz)
    want = {"params": transplant_collection(variant, variables["params"], {"unet": pre_p}),
            "batch_stats": transplant_collection(variant, variables["batch_stats"],
                                                 {"unet": pre_s})}
    copied = apply_pretrained_encoder(model, npz, variant)
    got = dict(zip(("params", "batch_stats"), to_flax(model.state_dict())))
    for coll in want:
        w, g = _flat(want[coll]), _flat(got[coll])
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    n_enc = len(encoder_state(npz))
    stem = "unet.unet.enc_l1.conv1.weight"
    if kind == "cat":  # the 6-channel stem keeps its initial value
        assert stem not in copied and len(copied) == n_enc - 1
        assert torch.equal(model.state_dict()[stem], before[stem])
    else:
        assert len(copied) == n_enc
    assert all(not torch.equal(model.state_dict()[k], before[k]) for k in copied)


# ------------------------------------------------------------ --fold_eval_bn 0

def _perturb(variables, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        draws = {"['scale']": lambda: rng.uniform(0.5, 1.5, leaf.shape),
                 "['bias']": lambda: rng.normal(0, 0.1, leaf.shape),
                 "['mean']": lambda: rng.normal(0, 0.1, leaf.shape),
                 "['var']": lambda: rng.uniform(0.5, 2.0, leaf.shape)}
        for suffix, fn in draws.items():
            if key.endswith(suffix):
                return fn()
        return np.asarray(leaf, np.float64) * 1.7

    return jax.tree_util.tree_map_with_path(draw, variables)


F64 = torch.float64
MODULES = {
    "resnet-bottleneck": (lambda: jrn.Bottleneck(16, downsample=True, dtype=jnp.float64),
                          lambda: resnet.Bottleneck(32, 16, downsample=True, dtype=F64), 32),
    "resnet-stem": (lambda: jrn.ResNetStem(dtype=jnp.float64),
                    lambda: resnet.ResNetStem(3, F64), 3),
    "resnest-bottleneck": (
        lambda: jrs.ResNeStBottleneck(16, stride=2, downsample=True, downsample_pool_stride=2,
                                      is_first=True, dtype=jnp.float64),
        lambda: resnest.ResNeStBottleneck(32, 16, stride=2, downsample=True,
                                          downsample_pool_stride=2, is_first=True, dtype=F64),
        32),
    "resnest-stem": (lambda: jrs.ResNeStStem(stem_width=8, dtype=jnp.float64),
                     lambda: resnest.ResNeStStem(3, 8, F64), 3),
    "conv-layer": (lambda: jl.ConvLayer(16, dtype=jnp.float64),
                   lambda: layers.ConvLayer(8, 16, F64), 8),
    "attention-layer": (lambda: jl.AttentionLayer(16, dtype=jnp.float64),
                        lambda: layers.AttentionLayer(8, 16, F64), 8),
    "ppm": (lambda: jl.PPM(dtype=jnp.float64), lambda: layers.PPM(16, F64), 16),
    "aspp": (lambda: jl.ASPP(dilation=2, dtype=jnp.float64), lambda: layers.ASPP(16, 2, F64), 16),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_stock_eval_batchnorm_matches_jax(name, monkeypatch):
    """Eval mode outside ``fold_eval_bn_scope``: flax's ``_normalize`` with
    the running statistics at every call site, in float64 at 1e-12."""
    jmod_of, tmod_of, cin = MODULES[name]
    x = np.random.default_rng(4).normal(size=(2, 17, 17, cin))
    tmod = tmod_of().double()
    # the port module's initial weights as flax variables: no flax init trace
    # (the trees are equal by name and shape, test_torch_resnest.py and
    # test_torch_decoder_options.py)
    variables = _perturb(dict(zip(("params", "batch_stats"), to_flax(tmod.state_dict()))), 1)
    with jax.enable_x64():
        with jl.fold_eval_bn_scope(False):
            want = np.asarray(jmod_of().apply(variables, jnp.asarray(x), False))
    tmod.load_state_dict(from_flax(variables["params"], variables["batch_stats"]), strict=True)
    calls = []
    stock = layers.BatchNorm.normalize_eval
    monkeypatch.setattr(layers.BatchNorm, "normalize_eval",
                        lambda self, *a: calls.append(1) or stock(self, *a))
    with torch.no_grad(), layers.fold_eval_bn_scope(False):
        got = tmod(torch.from_numpy(x), False).numpy()
    assert calls, "the stock eval normalize never ran"
    assert got.shape == want.shape
    # the split attention pools in float32 in both packages
    # (test_torch_resnest.py holds its modules at eval to 1e-6 as well)
    tol = 1e-6 if name == "resnest-bottleneck" else 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_eval_step_with_fold_eval_bn_0_matches_jax():
    """The ResNet-50 ``UNetLoc`` eval step with the gates and PPM (TTA, the
    fused tail, which keeps its folds) at ``precision=32`` against JAX's
    with ``fold_eval_bn=False``."""
    kw = dict(type="pre", encoder="resnet50", precision=32, tta=True, fused_tail=True,
              attention=True, ppm=True, fold_eval_bn=False)
    variables = center_head(kw, jax_variables(kw))
    data = eval_batch(2, 3)
    jcfg = JaxConfig(**kw)
    jf1, jloss, jlog = jax.jit(jax_make_eval_step(jcfg, jax_build_model(jcfg)))(
        variables["params"], variables["batch_stats"], jax_init_f1(2), *data)
    cfg = Config(**kw)
    model = build_model(cfg)
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]), strict=True)
    tf1, tloss, tlog = steps.make_eval_step(cfg, model, device="cpu")(init_f1_state(2), *data)
    jlog = np.asarray(jlog)
    assert np.isfinite(jlog).all() and 0.2 < (jlog.argmax(-1) == 1).mean() < 0.8
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=2e-4,
                               atol=2e-4 * max(1.0, np.abs(jlog).max()))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for name in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(getattr(tf1, name).numpy(), np.asarray(getattr(jf1, name)))


# ------------------------------------------------------------ --remat

REMAT_KW = dict(type="pre", encoder="resnet50", precision=64, loss_str="focal+dice")
_CONV_BN = pfc._conv_bn_forward


def _remat_step(mode, fused, monkeypatch):
    """One float64 forward and backward of ``forward_loss`` under ``mode``:
    (loss, gradients, buffers, the fused kernel's outputs in call order)."""
    cfg = Config(**REMAT_KW, fused_tail=fused, remat=mode)
    model, _ = seeded_model(REMAT_KW)
    before = {n: b.clone() for n, b in model.named_buffers()}
    outs = []
    monkeypatch.setattr(pfc, "_conv_bn_forward",
                        lambda *a: (lambda r: outs.append(r[0].clone()) or r)(_CONV_BN(*a)))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)))
    y = relayout_standard(packed_loss_view_labels(
        torch.from_numpy((rng.random((2, 64, 64)) > 0.7).astype(np.int32))))
    loss_of = steps.rematerialized(
        functools.partial(steps.forward_loss, cfg, model, make_loss_fn(cfg.loss_str, cfg.type)),
        mode)
    with layers.remat_tail_scope(mode == "tail"):
        loss = loss_of(x, y, y)
    loss.backward()
    return (loss.item(), {n: p.grad for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()}, outs, before)


@pytest.mark.parametrize("mode", ["tail", "dots", "full"])
def test_remat_equals_none_in_float64(mode, monkeypatch):
    """``dots`` and ``full`` against the same step without remat, ``tail``
    against the stock tail (it turns the fused tail off, as in JAX): the
    loss, every gradient and every running statistic EQUAL, so the
    statistics moved once; under a whole-step checkpoint the recomputation
    launches the fused conv again and its outputs equal the first forward's."""
    fused = mode != "tail"
    loss0, grads0, bufs0, outs0, before = _remat_step("none", fused, monkeypatch)
    loss, grads, bufs, outs, _ = _remat_step(mode, fused, monkeypatch)
    assert loss == loss0
    for k, g in grads0.items():
        assert torch.equal(grads[k], g), k
    for k, b in bufs0.items():
        assert torch.equal(bufs[k], b), k
        assert not torch.equal(b, before[k]), k
    if mode == "tail":
        assert outs == outs0 == []
    else:  # dec_l5's fused chain at 64^2, launched again in the recomputation
        n = len(outs0)
        assert n > 0 and len(outs) == 2 * n
        for a, b, c in zip(outs0, outs[:n], outs[n:]):
            assert torch.equal(a, b) and torch.equal(b, c)
