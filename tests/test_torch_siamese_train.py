"""One train step of the Siamese damage model in float64
(``Config(precision=64)``, ``jax.enable_x64``) against the JAX package's, on
the same weights and the same crop, with the fused tail at a geometry that
reaches it: the loss (``ohem`` is the masked mean CE under the post task's
mask, and ``focal``), every gradient leaf of the shared template and the
packed two-branch head, and the running statistics after the pre branch
and then the post branch updated them.  The JAX side is traced once for
both losses (``torch_jax_variables.jax_train_grads``), in a module fixture.

Tolerances as ``tests/test_torch_train_step.py`` holds the localization
step: loss rtol 1e-9, every gradient leaf within 1e-6 of its scale, running
statistics rtol 1e-9.  The encoder is ResNet-50: the ResNeSt split attention
pools in float32 in both packages, each summing in its own order, and in a
train step ``bn1`` normalizes over the batch's few pooled values, which
carries that float32 ulp far past 1e-9 of the loss; its train mode is held
module by module in ``test_torch_resnest.py``."""

import jax
import numpy as np
import pytest
import torch

from test_torch_train_step import _close, _flat
from torch_jax_variables import (jax_train_grads, jax_variables,  # noqa: F401
                                 one_torch_thread, port_model)
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.ops.losses import make_loss_fn, packed_loss_view_labels
from xview2_tpu_torch.parallel import steps as port_steps
from xview2_tpu_torch.weights import to_flax

LOSSES = ("ohem+dice", "focal+dice")
KW = dict(type="post", dmg_model="siamese", encoder="resnet50", loss_str=LOSSES[0],
          precision=64, fused_tail=True, optimizer="adamw")


@pytest.fixture(scope="module")
def jax_step():
    """The weights, the crop and JAX's (loss, gradients, statistics) for
    each loss of LOSSES."""
    size = 64
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, size, size, 6))
    y = rng.integers(0, 5, (2, size, size)).astype(np.int32)
    y[1, :4, :6] = 255
    with jax.enable_x64():
        variables = jax_variables(KW, seed=2, dtype=np.float64)
        results = dict(zip(LOSSES, jax_train_grads(KW, variables, x, y, LOSSES)))
    return variables, x, y, results


@pytest.mark.parametrize("loss_str", LOSSES)
def test_siamese_train_step_f64_matches_jax(loss_str, jax_step):
    """One train step in float64 with the fused tail (the port's plain
    versions of K2-K5 here, JAX's Pallas kernels in interpret mode): the
    loss, every gradient leaf of the shared template and the packed head,
    and the running statistics after both branches updated them."""
    variables, x, y, results = jax_step
    jloss, jgrads, jstats = results[loss_str]
    kw = dict(KW, loss_str=loss_str)
    cfg = Config(**kw)
    model = port_model(kw, variables)
    loss = port_steps.forward_loss(cfg, model, make_loss_fn(cfg.loss_str, cfg.type),
                                   torch.from_numpy(x),
                                   packed_loss_view_labels(torch.from_numpy(y)))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert loss.item() == pytest.approx(jloss, rel=1e-9)
    got = _flat(to_flax(dict(zip(names, grads)))[0])
    assert set(got) == set(jgrads)
    for key, want in jgrads.items():
        _close(got[key], want, 1e-6, f"gradient {key}")
    got_s = _flat(to_flax({k: v for k, v in model.state_dict().items() if "running" in k})[1])
    assert set(got_s) == set(jstats)
    for key, want in jstats.items():
        np.testing.assert_allclose(got_s[key], want, rtol=1e-9, atol=1e-12, err_msg=key)
        assert not np.array_equal(want, _flat(variables["batch_stats"])[key])
