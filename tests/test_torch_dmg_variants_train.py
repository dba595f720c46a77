"""One train step of the damage variants in float64 (``Config(precision=64)``,
``jax.enable_x64``) against the JAX package's, on the same weights and the
same crop, with the fused tail at a geometry that reaches it (64^2: each
branch's packed dec_l5 and, for ``fused``, the packed cross-fusion take the
fused route): the loss, every gradient leaf and the running statistics.
Configuration C's variant, ``fused`` with the CORAL head, is in tier-1; the
other six, each with another loss (``mse`` and ``coral`` among them), are
``slow``, as the JAX package's whole-network twins are.  ResNet-50, as
``test_torch_siamese_train.py`` explains.

Tolerances as ``test_torch_siamese_train.py``: loss rtol 1e-9, every
gradient leaf within 1e-6 of its scale, running statistics rtol 1e-9."""

import jax
import numpy as np
import pytest
import torch

from test_torch_train_step import _close, _flat
from torch_jax_variables import jax_train_grads, one_torch_thread, seeded_model  # noqa: F401
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.ops import packed_fused_conv as port_pfc
from xview2_tpu_torch.ops.losses import make_loss_fn, packed_loss_view_labels
from xview2_tpu_torch.parallel import steps as port_steps
from xview2_tpu_torch.weights import to_flax


def _train_step_case(dmg_model, loss_str):
    size = 64
    kw = dict(type="post", dmg_model=dmg_model, encoder="resnet50", loss_str=loss_str,
              precision=64, fused_tail=True, optimizer="adamw")
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, size, size, 6))
    y = rng.integers(0, 5, (2, size, size)).astype(np.int32)
    y[0, :4, :6] = 255
    model, variables = seeded_model(kw, seed=3)
    with jax.enable_x64():
        (jloss, jgrads, jstats), = jax_train_grads(kw, variables, x, y, [loss_str])
    stats0 = _flat(variables["batch_stats"])
    del variables

    cfg = Config(**kw)
    launches = port_pfc.conv_bn_fused.launches
    loss = port_steps.forward_loss(cfg, model, make_loss_fn(cfg.loss_str, cfg.type),
                                   torch.from_numpy(x),
                                   packed_loss_view_labels(torch.from_numpy(y)))
    names, params = zip(*model.named_parameters())
    # fusedEnc never reads its last pre-branch cross-fusion: JAX's gradient is 0 there
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
    assert port_pfc.conv_bn_fused.launches == launches  # the CPU runs the plain versions
    assert loss.item() == pytest.approx(jloss, rel=1e-9)
    got = _flat(to_flax(dict(zip(names, grads)))[0])
    assert set(got) == set(jgrads)
    for key, want in jgrads.items():
        _close(got[key], want, 1e-6, f"gradient {key}")
    got_s = _flat(to_flax({k: v for k, v in model.state_dict().items() if "running" in k})[1])
    assert set(got_s) == set(jstats)
    for key, want in jstats.items():
        np.testing.assert_allclose(got_s[key], want, rtol=1e-9, atol=1e-12, err_msg=key)
        assert not np.array_equal(want, stats0[key])


def test_fused_coral_train_step_f64_matches_jax():
    """Configuration C's variant and head: two encoders and decoders with
    cross-fusion after every stage, the packed cross-fusion through the
    fused route (K2 forward, K4/K5 backward, their plain versions here; JAX's
    Pallas kernels in interpret mode), the CORAL head through the fused head
    and its ordinal bias on the loss view, and the CORAL loss."""
    _train_step_case("fused", "coral")


@pytest.mark.slow
@pytest.mark.parametrize("dmg_model,loss_str", [
    ("siameseEnc", "ohem+dice"), ("fusedEnc", "mse"), ("parallel", "coral"),
    ("parallelEnc", "focal+dice"), ("diff", "ohem+dice"), ("cat", "coral")])
def test_variant_train_step_f64_matches_jax(dmg_model, loss_str):
    _train_step_case(dmg_model, loss_str)
