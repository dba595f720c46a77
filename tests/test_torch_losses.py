"""The port's losses, F1 state and input normalization against the JAX
package on the same numpy inputs: focal, dice and ``make_loss_fn`` (pre and
post, label-255 masking, ``sample_valid``) at rtol 1e-5; ce and ohem (with
and without a mask, ties at OHEM's hard-negative budget, an image without
positives) at rtol 1e-6; mse and coral (labels past both ends of CORAL's
table, with and without a mask, and through ``make_loss_fn``) and their
gradients in float64 at rtol 1e-12; F1 counts equal; ``normalize`` (RGB and
``--bgr``, 3 and 6 channels) at rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xview2_tpu.ops import augment as jaug
from xview2_tpu.ops import losses as jlosses
from xview2_tpu.ops import metrics as jmetrics
from xview2_tpu_torch.ops import augment, losses, metrics


def _logits(n_class, seed=0, shape=(3, 16, 16)):
    return np.random.default_rng(seed).normal(0, 2, size=shape + (n_class,)).astype(np.float32)


def _labels(hi, seed=1, shape=(3, 16, 16)):
    lab = np.random.default_rng(seed).integers(0, hi, size=shape).astype(np.int32)
    lab[0, :2] = 255  # un-classified pixels
    return lab


@pytest.mark.parametrize("name", ["focal", "dice"])
@pytest.mark.parametrize("n_class", [2, 4])
def test_loss_terms_match_jax(name, n_class):
    logits, labels = _logits(n_class), _labels(n_class)
    mask = (np.random.default_rng(2).random(labels.shape) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = getattr(jlosses, f"{name}_loss")(jnp.asarray(logits), jnp.asarray(labels),
                                                None if m is None else jnp.asarray(m))
        got = getattr(losses, f"{name}_loss")(torch.from_numpy(logits),
                                              torch.from_numpy(labels).long(),
                                              None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("task,n_class", [("pre", 2), ("post", 4)])
def test_make_loss_fn_matches_jax(task, n_class):
    logits, labels = _logits(n_class, seed=3), _labels(5 if task == "post" else 2, seed=4)
    valid = np.array([1.0, 1.0, 0.0], np.float32)
    want = jlosses.make_loss_fn("focal+dice", task)(jnp.asarray(logits), jnp.asarray(labels),
                                                    sample_valid=jnp.asarray(valid))
    got = losses.make_loss_fn("focal+dice", task)(torch.from_numpy(logits),
                                                  torch.from_numpy(labels),
                                                  sample_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="unknown loss term"):
        losses.make_loss_fn("bogus+dice", task)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("n_class", [2, 4])
@pytest.mark.parametrize("name", ["ce", "ohem"])
def test_ce_and_ohem_match_jax(name, n_class, masked):
    logits, labels = _logits(n_class, seed=8), _labels(n_class, seed=9)
    labels[1] = 0  # an image without positives: OHEM keeps its budget of negatives only
    mask = (np.random.default_rng(10).random(labels.shape) > 0.3).astype(np.float32)
    m = mask if masked else None
    want = getattr(jlosses, f"{name}_loss")(jnp.asarray(logits), jnp.asarray(labels),
                                            None if m is None else jnp.asarray(m))
    got = getattr(losses, f"{name}_loss")(torch.from_numpy(logits),
                                          torch.from_numpy(labels).long(),
                                          None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("name,n_logit", [("mse", 1), ("coral", 3)])
def test_mse_and_coral_and_their_gradients_match_jax(name, n_logit, masked):
    """In float64: the value and the gradient with respect to the logits;
    labels 0..5 (CORAL clips to its 4-row table, MSE regresses the label),
    negative logits (MSE's relu)."""
    rng = np.random.default_rng(15)
    logits = rng.normal(0, 2, (3, 8, 8, n_logit))
    labels = rng.integers(0, 6, (3, 8, 8)).astype(np.int32)
    mask = (rng.random(labels.shape) > 0.3).astype(np.float32) if masked else None
    with jax.enable_x64():
        jfn = getattr(jlosses, f"{name}_loss")
        jm = None if mask is None else jnp.asarray(mask)
        want, jgrad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(labels), jm))(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = getattr(losses, f"{name}_loss")(x, torch.from_numpy(labels).long(),
                                          None if mask is None else torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(got, x)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("loss_str,n_logit", [("mse", 1), ("coral", 3), ("coral+dice", 3)])
def test_make_loss_fn_mse_coral_matches_jax(loss_str, n_logit):
    """The post task's mask, label shift and 255 masking around the mse and
    coral terms, with ``sample_valid``."""
    logits, labels = _logits(n_logit, seed=16), _labels(5, seed=17)
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    want = jlosses.make_loss_fn(loss_str, "post")(jnp.asarray(logits), jnp.asarray(labels),
                                                 sample_valid=jnp.asarray(valid))
    got = losses.make_loss_fn(loss_str, "post")(torch.from_numpy(logits),
                                               torch.from_numpy(labels),
                                               sample_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("levels", [3, 1], ids=["three-values", "all-equal"])
def test_ohem_ties_at_the_budget_match_jax(levels):
    """Negatives whose CE ties across the hard-negative budget's edge (logits
    on a few levels, or all the same): both rank stably, and the sum over
    the kept pixels does not depend on which of the tied ones are kept."""
    rng = np.random.default_rng(12)
    logits = rng.integers(0, levels, (2, 12, 12, 2)).astype(np.float32)
    labels = (rng.random((2, 12, 12)) > 0.9).astype(np.int32)
    want = jlosses.ohem_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = losses.ohem_loss(torch.from_numpy(logits), torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("loss_str", ["ohem+dice", "ce", "focal+ohem"])
@pytest.mark.parametrize("task,n_class", [("pre", 2), ("post", 4)])
def test_make_loss_fn_ce_ohem_matches_jax(loss_str, task, n_class):
    logits, labels = _logits(n_class, seed=13), _labels(5 if task == "post" else 2, seed=14)
    for valid in (None, np.array([1.0, 0.0, 1.0], np.float32)):
        kw_j = {} if valid is None else dict(sample_valid=jnp.asarray(valid))
        kw_t = {} if valid is None else dict(sample_valid=torch.from_numpy(valid))
        want = jlosses.make_loss_fn(loss_str, task)(jnp.asarray(logits), jnp.asarray(labels),
                                                    **kw_j)
        got = losses.make_loss_fn(loss_str, task)(torch.from_numpy(logits),
                                                  torch.from_numpy(labels), **kw_t)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("n_class,loss_str,n_logit", [(2, "focal+dice", 2),
                                                      (5, "focal+dice", 4), (5, "mse", 1),
                                                      (5, "coral", 3)])
def test_f1_state_matches_jax(n_class, loss_str, n_logit):
    logits, targets = _logits(n_logit, seed=5), _labels(n_class, seed=6)
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    want = jmetrics.update_f1_state(jmetrics.init_f1_state(n_class), jnp.asarray(logits),
                                    jnp.asarray(targets), n_class=n_class, loss_str=loss_str,
                                    sample_valid=jnp.asarray(valid))
    got = metrics.update_f1_state(metrics.init_f1_state(n_class), torch.from_numpy(logits),
                                  torch.from_numpy(targets), n_class=n_class,
                                  loss_str=loss_str, sample_valid=torch.from_numpy(valid))
    for name in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    f_want, pc_want = jmetrics.compute_f1(want, n_class)
    f_got, pc_got = metrics.compute_f1(got, n_class)
    np.testing.assert_array_equal(np.float32(f_got), np.float32(f_want))
    if n_class == 5:
        np.testing.assert_array_equal(pc_got, np.asarray(pc_want))


@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("bgr", [False, True])
def test_normalize_matches_jax(channels, bgr):
    img = np.random.default_rng(7).integers(0, 256, (2, 8, 8, channels), np.uint8)
    want = jaug.eval_batch(jnp.asarray(img), bgr=bgr)
    got = augment.eval_batch(torch.from_numpy(img), bgr=bgr)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
