"""The port's Siamese damage model and what the damage task adds around it,
against the JAX package on the same weights (``weights.from_flax``) and the
same numpy inputs: ``concat_registered`` of deferred folds, the whole
Siamese eval step (float32, fused tail on and off, ResNet-50 and ResNeSt-50
encoders), the 6-channel augmentation on JAX's own draws, and the
``--ckpt_pre`` encoder transplant (the train step: ``test_torch_siamese_train.py``).
The weights of each encoder are built once for both tails (a module
fixture).

Tolerances: the eval step's logits at 2e-4 of their scale (the JAX
package's fused-vs-stock tolerance), its loss at rtol 1e-5; each F1 count
equal up to the pixels whose two largest JAX logits lie within twice that
tolerance (four balanced classes leave a few near ties); augmentation:
labels equal, images at 1e-5 without the zoom and 5e-3 with it
(``tests/test_torch_augment.py``); the transplant exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_augment import CROP, SIZE, _stack, jax_draws
from test_torch_train_step import _flat
from torch_jax_variables import (center_head, eval_batch, jax_variables,  # noqa: F401
                                 one_torch_thread, port_model)
from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu.ops import augment as jaug
from xview2_tpu.ops.metrics import init_f1_state as jax_init_f1
from xview2_tpu.parallel.steps import make_eval_step as jax_make_eval_step
from xview2_tpu.parallel.transplant import transplant_encoder as jax_transplant
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models import layers
from xview2_tpu_torch.ops import augment as taug
from xview2_tpu_torch.ops import packed_fused_conv as port_pfc
from xview2_tpu_torch.ops.metrics import init_f1_state
from xview2_tpu_torch.parallel.steps import make_eval_step
from xview2_tpu_torch.parallel.transplant import transplant_encoder
from xview2_tpu_torch.weights import from_flax, to_flax

POST = dict(type="post", dmg_model="siamese", loss_str="ohem+dice")


def _fold(c, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(c, generator=g) for _ in range(3))


def test_concat_registered_joins_deferred_folds():
    a, b = torch.randn(2, 4, 4, 8), torch.randn(2, 4, 4, 8)
    fa, fb = _fold(8, 0), _fold(8, 1)
    with layers.fused_tail_scope(True, defer_head=True) as outstanding:
        ca, cb = layers.defer_fold(a, fa), layers.defer_fold(b, fb)
        joined = layers.concat_registered(ca, cb)
        assert outstanding == [joined]          # the branches' carriers are consumed
        raw, fold = layers.consume_fold(joined)
    assert torch.equal(raw, torch.cat([a, b], dim=-1))
    for got, va, vb in zip(fold, fa, fb):
        assert torch.equal(got, torch.cat([va, vb]))
    # the fused head on the joined carrier is the head on the two activated branches
    kmat, hbias = torch.randn(16, 4), torch.randn(4)
    act = torch.cat([port_pfc.prologue(a, fa), port_pfc.prologue(b, fb)], dim=-1)
    want = torch.matmul(act, kmat) + hbias
    torch.testing.assert_close(port_pfc.head_conv_fused(raw, kmat, hbias, fold), want)
    assert torch.equal(layers.concat_registered(a, b), torch.cat([a, b], dim=-1))


def test_concat_registered_refuses_one_deferred_branch():
    with pytest.raises(AssertionError, match="asymmetric"):
        with layers.fused_tail_scope(True, defer_head=True):
            layers.concat_registered(layers.defer_fold(torch.zeros(1, 2, 2, 4), _fold(4, 2)),
                                     torch.zeros(1, 2, 2, 4))


@pytest.fixture(scope="module")
def siamese_weights():
    """Per encoder, built once for both tails: the flax variables (the head
    centered with the fused tail) and the port model loaded with them (eval
    mode leaves it as it is)."""
    cache = {}

    def get(encoder):
        if encoder not in cache:
            kw = dict(POST, encoder=encoder, precision=32, tta=True, fused_tail=True)
            variables = center_head(kw, jax_variables(kw, seed=4))
            cache[encoder] = variables, port_model(kw, variables)
        return cache[encoder]

    return get


@pytest.mark.parametrize("fused_tail", [True, False], ids=["fused", "stock"])
@pytest.mark.parametrize("encoder", ["resnet50", "resnest50"])
def test_siamese_eval_step_f32_matches_jax(encoder, fused_tail, siamese_weights):
    kw = dict(POST, encoder=encoder, precision=32, tta=True, fused_tail=fused_tail)
    variables, model = siamese_weights(encoder)
    data = eval_batch(6, 6)
    jcfg = JaxConfig(**kw)
    jf1, jloss, jlog = jax.jit(jax_make_eval_step(jcfg, jax_build_model(jcfg)))(
        variables["params"], variables["batch_stats"], jax_init_f1(5), *data)
    jlog = np.asarray(jlog)
    cfg = Config(**kw)
    launches = port_pfc.head_conv_fused.launches
    tf1, tloss, tlog = make_eval_step(cfg, model, device="cpu")(init_f1_state(5), *data)
    assert port_pfc.head_conv_fused.launches == launches  # the CPU runs the plain versions
    tlog = tlog.numpy()
    assert tlog.shape == (2, 64, 64, 4) and np.isfinite(jlog).all()
    assert len(np.unique(jlog.argmax(-1))) == 4
    scale = max(1.0, np.abs(jlog).max())
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    top2 = np.sort(jlog, axis=-1)[..., -2:]
    counted = (data[1] > 0) & (data[2][:, None, None] > 0)
    ties = int(((top2[..., 1] - top2[..., 0] <= 4e-4 * scale) & counted).sum())
    assert ties <= 0.01 * counted.sum()
    for name in ("tp", "fp", "fn"):
        diff = np.abs(getattr(tf1, name).numpy() - np.asarray(getattr(jf1, name)))
        assert diff.max() <= ties, (name, diff, ties)


def _pair_draws(key, mask):
    """``jax_draws`` plus the post half's intensity chain (``k_int_post``)."""
    d = jax_draws(key, mask, CROP)
    _, _, _, k_int_post = jax.random.split(key, 4)
    k_noise_chain, k_bc_chain = jax.random.split(k_int_post)
    kn_p, kn_var, kn_noise = jax.random.split(k_noise_chain, 3)
    kb_p, kb_a, kb_b = jax.random.split(k_bc_chain, 3)
    post = dict(noise_do=jax.random.bernoulli(kn_p, 0.1),
                noise_var=jax.random.uniform(kn_var, (), minval=10.0, maxval=50.0),
                noise=jax.random.normal(kn_noise, (CROP, CROP, 3)),
                bc_do=jax.random.bernoulli(kb_p, 0.2),
                alpha=1.0 + jax.random.uniform(kb_a, (), minval=-0.2, maxval=0.2),
                beta=jax.random.uniform(kb_b, (), minval=-0.2, maxval=0.2))
    return d, post


def test_pair_augmentation_matches_jax_on_its_draws():
    """6-channel pre/post pairs: one set of spatial draws for both halves,
    the intensity chains drawn independently (seeds chosen so that noise
    and brightness fire on one half and not the other, with and without
    the zoom)."""
    rng = np.random.default_rng(11)
    aug = jax.jit(functools.partial(jaug.augment_sample, crop=CROP))
    wanted = [lambda d, p: bool(d["noise_do"]) != bool(p["noise_do"]),
              lambda d, p: bool(d["bc_do"]) != bool(p["bc_do"]) and not bool(d["do_zoom"]),
              lambda d, p: bool(d["do_zoom"]) and bool(p["bc_do"]),
              lambda d, p: bool(d["flip_h"]) and not bool(d["do_zoom"])]
    imgs, masks, pre, post, want = [], [], [], [], []
    for i, pred in enumerate(wanted):
        img = rng.integers(0, 256, (SIZE, SIZE, 6), np.uint8)
        mask = np.zeros((SIZE, SIZE), np.uint8)
        mask[20 + i:40, 30:45 + i] = rng.integers(1, 5)
        seed = next(s for s in range(50 * i, 50 * i + 2000)
                    if pred(*_pair_draws(jax.random.PRNGKey(s), mask)))
        key = jax.random.PRNGKey(seed)
        d, p = _pair_draws(key, mask)
        imgs.append(img)
        masks.append(mask)
        pre.append(d)
        post.append(p)
        want.append(tuple(np.asarray(a) for a in aug(key, jnp.asarray(img), jnp.asarray(mask))))
    draws = _stack(pre, post)
    x, y = taug.apply_augment(torch.from_numpy(np.stack(imgs)), torch.from_numpy(np.stack(masks)),
                              draws, crop=CROP)
    assert x.shape == (len(wanted), CROP, CROP, 6)
    for i, (wx, wy) in enumerate(want):
        np.testing.assert_array_equal(y[i].numpy(), wy)
        atol = 5e-3 if bool(draws.do_zoom[i]) else 1e-5
        np.testing.assert_allclose(x[i].numpy(), wx, rtol=0, atol=atol)
    with pytest.raises(ValueError):  # 6 channels need both halves' draws
        taug.apply_augment(torch.from_numpy(np.stack(imgs)), torch.from_numpy(np.stack(masks)),
                           _stack(pre), crop=CROP)


def test_pair_draws_cover_both_halves():
    masks = torch.zeros((2, SIZE, SIZE), dtype=torch.uint8)
    masks[:, 10:20, 30:40] = 3
    d = taug.draw_augment(torch.Generator().manual_seed(3), masks, CROP, channels=6)
    assert d.post is not None and d.post.noise.shape == (2, CROP, CROP, 3)
    assert not torch.equal(d.post.noise, d.pre.noise)
    assert not torch.equal(d.post.alpha, d.pre.alpha)
    x, y = taug.augment_batch(torch.Generator().manual_seed(3), torch.zeros(
        (2, SIZE, SIZE, 6), dtype=torch.uint8), masks, CROP)
    assert x.shape == (2, CROP, CROP, 6) and int(y.max()) == 3
    # --autoaugment on pairs: one draw per sample for both halves
    x, y = taug.augment_batch(torch.Generator(), torch.zeros((2, SIZE, SIZE, 6),
                                                             dtype=torch.uint8),
                              masks, CROP, use_autoaugment=True)
    assert x.shape == (2, CROP, CROP, 6) and int(y.max()) == 3


def test_transplant_matches_jax():
    """``--ckpt_pre``: the localization encoder into the Siamese template,
    params and running statistics, a leaf of another shape skipped, on the
    same trees as JAX's ``transplant_encoder``."""
    pre_kw = dict(type="pre", encoder="resnet50", precision=32)
    loc = jax_variables(pre_kw, seed=5)
    dmg = jax_variables(dict(POST, encoder="resnet50", precision=32), seed=6)
    stem = loc["params"]["unet"]["enc_l1"]["conv1"]
    stem["kernel"] = np.ones((7, 7, 6, 64), np.float32)  # another shape: kept from the target
    want_p, want_s = jax_transplant("siamese", dmg["params"], dmg["batch_stats"], loc["params"],
                                    loc["batch_stats"])
    model = port_model(dict(POST, encoder="resnet50", precision=32), dmg)
    copied = transplant_encoder("siamese", model,
                                from_flax(loc["params"], loc["batch_stats"]))
    enc = [k for k in model.state_dict() if k.startswith("unet.enc_l")]
    assert sorted(copied) == sorted(k for k in enc if k != "unet.enc_l1.conv1.weight")
    got_p, got_s = to_flax(model.state_dict())
    for got, want in ((got_p, want_p), (got_s, want_s)):
        g, w = _flat(got), _flat(jax.device_get(want))
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    with pytest.raises(ValueError, match="unknown dmg_model"):
        transplant_encoder("bogus", model, {})
