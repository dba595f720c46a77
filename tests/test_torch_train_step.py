"""The train slice as a whole against the JAX train step, in float64
(``Config(precision=64)``, ``jax.enable_x64``): the same weights through
``weights.from_flax``, the same augmented crop fed to both (augmentation has
its own test), ``fused_tail=True`` at a geometry that reaches the fused
route, so the port runs K2/K3 forward and K4/K5 backward (their plain
versions here) and the JAX package its Pallas kernels in interpret mode.

One step: the loss, EVERY gradient leaf and the running statistics.  Then
K = 3 steps with SGD (momentum 0.9), as ``tests/test_train_trajectory_parity``
does: losses, parameter DELTAS and ``batch_stats`` per step.

Tolerances: loss rtol 1e-9; gradients 1e-6 of the leaf's scale (float64 sums
in another order through ResNet-50's depth; float32 would leave up to 37% of
leaf scale on cancelling leaves); running statistics rtol 1e-9; trajectory
deltas 1e-4 of the leaf's max |delta| (the per-step noise is re-linearized
through the ill-conditioned BN-statistics path and compounds)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models.layers import fused_tail_scope as jax_fused_tail_scope
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu.models.unet import emits_packed_loss_view, fused_head_defer_ok
from xview2_tpu.ops.layout import relayout_standard as jax_relayout
from xview2_tpu.ops.losses import make_loss_fn as jax_make_loss_fn
from xview2_tpu.ops.losses import packed_loss_view_labels as jax_packed_labels
from xview2_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.ops import packed_fused_conv as port_pfc
from xview2_tpu_torch.ops.losses import make_loss_fn, packed_loss_view_labels
from xview2_tpu_torch.parallel import steps as port_steps
from xview2_tpu_torch.train.optimizers import build_optimizer
from xview2_tpu_torch.weights import from_flax, to_flax

BASE = dict(type="pre", encoder="resnet50", precision=64, loss_str="focal+dice",
            fused_tail=True)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _variables(cfg_kw, size, seed=0):
    """Flax init in float64 with BN statistics and affines drawn from a numpy
    seed and conv kernels scaled so activations stay O(1)."""
    model = jax_build_model(JaxConfig(**cfg_kw))
    variables = jax.device_get(jax.jit(model.init, static_argnums=2)(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), True))
    rng = np.random.default_rng(seed + 1)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith("['kernel']"):
            return np.asarray(leaf, np.float64) * 2.2
        draws = {"['scale']": lambda: rng.uniform(0.5, 1.5, leaf.shape),
                 "['bias']": lambda: rng.normal(0, 0.1, leaf.shape),
                 "['mean']": lambda: rng.normal(0, 0.1, leaf.shape),
                 "['var']": lambda: rng.uniform(0.5, 2.0, leaf.shape)}
        for suffix, fn in draws.items():
            if key.endswith(suffix):
                return fn().astype(np.float64)
        return np.asarray(leaf, np.float64)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _batches(k, size, seed=3, b=2):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, size, size, 3)), (rng.random((b, size, size)) > 0.7)
             .astype(np.int32)) for _ in range(k)]


def _jax_steps(cfg_kw, variables, batches):
    """The numerics core of ``make_train_step`` (forward under the fused-tail
    scope, the relayout seam, the loss, the gradient, the optax update, the
    BN carry), augmentation excluded.  Yields (loss, grads, params, stats)."""
    cfg = JaxConfig(**cfg_kw)
    model = jax_build_model(cfg)
    tx = jax_build_optimizer(cfg, cfg.lr)
    loss_fn = jax_make_loss_fn(cfg.loss_str, cfg.type)
    assert emits_packed_loss_view(cfg)

    def forward_loss(p, bs, x, y_main):
        with jax_fused_tail_scope(bool(cfg.fused_tail), None,
                                  defer_head=fused_head_defer_ok(cfg)):
            outs, mutated = model.apply({"params": p, "batch_stats": bs}, x, True,
                                        mutable=["batch_stats"])
        return loss_fn(jax_relayout(outs), y_main), mutated["batch_stats"]

    @jax.jit
    def step(p, bs, opt_state, x, y):
        y_main = jax_relayout(jax_packed_labels(y))
        (loss, new_bs), grads = jax.value_and_grad(forward_loss, has_aux=True)(p, bs, x, y_main)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), new_bs, opt_state, loss, grads

    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    opt_state = tx.init(params)
    for x, y in batches:
        params, stats, opt_state, loss, grads = step(params, stats, opt_state,
                                                     jnp.asarray(x), jnp.asarray(y))
        yield float(loss), _flat(grads), _flat(params), _flat(stats)


def _port_model(cfg, variables):
    model = build_model(cfg).double()
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]), strict=True)
    return model


def _close(got, want, tol, name):
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def _one_step_case(size):
    kw = dict(BASE, optimizer="adamw")
    with jax.enable_x64():
        variables = _variables(kw, size)
        (x, y), = _batches(1, size)
        jloss, jgrads, _, jstats = next(_jax_steps(kw, variables, [(x, y)]))

    cfg = Config(**kw)
    model = _port_model(cfg, variables)
    launches = (port_pfc.conv_bn_fused.launches, port_pfc.conv_bn_wgrad.launches)
    loss = port_steps.forward_loss(cfg, model, make_loss_fn(cfg.loss_str, cfg.type),
                                   torch.from_numpy(x),
                                   packed_loss_view_labels(torch.from_numpy(y)))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert (port_pfc.conv_bn_fused.launches, port_pfc.conv_bn_wgrad.launches) == launches
    assert loss.item() == pytest.approx(jloss, rel=1e-9)
    gp, _ = to_flax(dict(zip(names, grads)))
    got = _flat(gp)
    assert set(got) == set(jgrads)
    for key, want in jgrads.items():
        _close(got[key], want, 1e-6, f"gradient {key}")
    _, stats = to_flax({k: v for k, v in model.state_dict().items() if "running" in k})
    got_s = _flat(stats)
    assert set(got_s) == set(jstats)
    for key, want in jstats.items():
        np.testing.assert_allclose(got_s[key], want, rtol=1e-9, atol=1e-12, err_msg=key)
        assert not np.array_equal(want, _flat(variables["batch_stats"])[key])


def test_one_step_f64_matches_jax_at_64():
    """64^2: the packed dec_l5 chain (32x32x128) and the head take the fused
    route; dec_l2/dec_l3 are below ``supported()``'s 16 rows."""
    _one_step_case(64)


def test_autoaugment_step_is_its_augmentation_then_the_same_step():
    """``make_train_step`` with ``cfg.autoaugment``: the loss equals
    ``forward_loss`` on ``augment_batch(..., use_autoaugment=True)`` from the
    same generator state, the parameters move, and the plain-augmentation
    step from the same seed sees another batch (another loss)."""
    from xview2_tpu_torch.ops.augment import augment_batch

    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (2, 96, 96, 3), np.uint8)
    masks = (rng.random((2, 96, 96)) > 0.8).astype(np.uint8)
    losses = {}
    for aa in (True, False):
        cfg = Config(type="pre", encoder="resnet50", precision=32, fused_tail=True,
                     optimizer="sgd", autoaugment=aa)
        torch.manual_seed(0)
        model = build_model(cfg)
        before = {k: v.clone() for k, v in model.named_parameters()}
        x, y = augment_batch(port_steps.step_generator(cfg, 0, "cpu"), torch.from_numpy(images),
                             torch.from_numpy(masks), crop=64, use_autoaugment=aa)
        with torch.no_grad():
            want = port_steps.forward_loss(cfg, model, make_loss_fn(cfg.loss_str, cfg.type), x,
                                           packed_loss_view_labels(y))
        torch.manual_seed(0)
        model = build_model(cfg)
        opt = build_optimizer(cfg, model.parameters(), cfg.lr)
        state = port_steps.init_train_state(model, opt, device="cpu")
        step = port_steps.make_train_step(cfg, model, opt, crop=64, device="cpu")
        state, loss = step(state, images, masks, port_steps.step_generator(cfg, 0, "cpu"))
        assert state.step == 1 and np.isfinite(loss.item())
        assert loss.item() == pytest.approx(want.item(), rel=1e-6)
        assert any(not torch.equal(v, before[k]) for k, v in model.named_parameters())
        losses[aa] = loss.item()
    assert losses[True] != losses[False]


@pytest.mark.slow
def test_one_step_f64_matches_jax_at_128():
    """128^2 also sends the fine dec_l2 (768->256) and dec_l3 (384->128)
    ConvBlocks through the fused route."""
    _one_step_case(128)


@pytest.mark.slow
def test_k_step_sgd_trajectory_matches_jax(monkeypatch):
    """K = 3 consecutive steps through the port's REAL ``make_train_step``
    (its augmentation replaced by the prepared crops) against the JAX core."""
    k_steps, size = 3, 64
    kw = dict(BASE, optimizer="sgd", lr=3e-4, momentum=0.9)
    with jax.enable_x64():
        variables = _variables(kw, size, seed=2)
        batches = _batches(k_steps, size, seed=5)
        want = list(_jax_steps(kw, variables, batches))

    cfg = Config(**kw)
    model = _port_model(cfg, variables)
    opt = build_optimizer(cfg, model.parameters(), cfg.lr)
    state = port_steps.init_train_state(model, opt, device="cpu")
    feed = iter(batches)
    monkeypatch.setattr(port_steps, "augment_batch", lambda gen, images, masks, crop, bgr: tuple(
        torch.from_numpy(a) for a in next(feed)))
    step = port_steps.make_train_step(cfg, model, opt, crop=size, device="cpu")
    flat0 = _flat(variables["params"])
    dummy = np.zeros((2, size, size, 3), np.uint8), np.zeros((2, size, size), np.uint8)
    for k, (jloss, _, jparams, jstats) in enumerate(want):
        state, loss = step(state, *dummy, port_steps.step_generator(cfg, k, "cpu"))
        assert state.step == k + 1
        assert loss.item() == pytest.approx(jloss, rel=1e-8), f"loss diverged at step {k}"
        params, stats = to_flax(model.state_dict())
        got_p, got_s = _flat(params), _flat(stats)
        for key, w in jparams.items():
            dw = w - flat0[key]
            _close(got_p[key] - flat0[key], dw, 1e-4, f"param delta {key}, step {k}")
        for key, w in jstats.items():
            np.testing.assert_allclose(got_s[key], w, rtol=1e-7, atol=1e-10,
                                       err_msg=f"batch_stats {key}, step {k}")
