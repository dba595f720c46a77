"""``--einsum_1x1`` in the port against the same model without it and
against JAX under its own ``einsum_1x1_scope``, in float64.

The 1x1 convs that JAX routes through ``Conv1x1`` (the bottlenecks'
``conv1``/``conv3`` and their shortcut, strided in ResNet-50's first block of
a stage, the attention gates' conv and PPM's ``reduce{i}``) run as matrix
products under the scope: ``F.conv2d`` is called that many times fewer.  The
UNetLoc models carry ``--attention --ppm``; train mode (batch statistics,
the running statistics updated) and eval mode.  Tolerances: the scope
against no scope 1e-12 of the output's scale (one sum order against
another); against JAX 1e-9 for ResNet-50 at eval and 1e-6 in train mode
(the stock packed tail's BatchNorm sums in float32 whatever the map's dtype,
in both packages: ROADMAP, reference behaviour; the same distance with the
scope off), and 1e-5 for ResNeSt-50 at eval, whose split attention pools in
float32 in both packages (the module parity of ``tests/test_torch_resnest.py``
is 1e-4).  A ResNeSt train-mode forward has no float64 parity with JAX (its
split attention's BatchNorm normalizes the batch's few float32 pooled values:
ROADMAP Queue 3 item 5), so there the port under the scope is held to JAX
under its scope within 1.25x the distance of the two without it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_jax_variables import one_torch_thread, seeded_model  # noqa: F401
from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models.layers import einsum_1x1_scope as jax_einsum_1x1_scope
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu_torch.models import layers
from xview2_tpu_torch.models.layers import AttentionLayer, PPM, einsum_1x1_scope
from xview2_tpu_torch.models.resnest import ResNeStBottleneck
from xview2_tpu_torch.models.resnet import Bottleneck

SIZE = 64
JAX_TOL = {("resnet50", False): 1e-9, ("resnet50", True): 1e-6, ("resnest50", False): 1e-5}


def _cfg_kw(encoder):
    return dict(type="pre", encoder=encoder, precision=64, attention=True, ppm=True,
                fused_tail=False)


def _conv1x1_sites(model) -> int:
    """The 1x1 convs of one forward that JAX computes through ``Conv1x1``."""
    n = 0
    for m in model.modules():
        if isinstance(m, (Bottleneck, ResNeStBottleneck)):
            n += 2 + bool(m.downsample)
        elif isinstance(m, AttentionLayer):
            n += 1
        elif isinstance(m, PPM):
            n += len(PPM.BINS)
    return n


def _port(model, x, train, einsum, monkeypatch):
    """The port's output (and running statistics) with the scope on or
    off, from the same weights, and the number of library convs called."""
    state = {k: v.clone() for k, v in model.state_dict().items()}
    calls, conv2d = [], F.conv2d

    def counted(*a, **kw):
        calls.append(1)
        return conv2d(*a, **kw)

    monkeypatch.setattr(layers.F, "conv2d", counted)
    try:
        with einsum_1x1_scope(einsum), torch.no_grad():
            out = model(torch.from_numpy(x), train).numpy()
    finally:
        monkeypatch.undo()
    stats = {k: v.clone().numpy() for k, v in model.state_dict().items() if "running" in k}
    model.load_state_dict(state)
    return out, stats, len(calls)


def _jax(kw, variables, x, train, einsum=True):
    model = jax_build_model(JaxConfig(**kw))

    def fwd(v, x):
        with jax_einsum_1x1_scope(einsum):
            if train:
                return model.apply(v, x, True, mutable=["batch_stats"])
            return model.apply(v, x, False), None

    out, _ = jax.jit(fwd)(jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    return np.asarray(out)


def _close(got, want, tol, what):
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("encoder", ["resnet50", "resnest50"])
def test_einsum_1x1_equals_the_convs_and_jax(encoder, train, monkeypatch):
    kw = _cfg_kw(encoder)
    model, variables = seeded_model(kw, seed=4)
    rng = np.random.default_rng(9)
    # per-sample contrast and brightness: the split attention's BatchNorm
    # over the batch's pooled values sees values that differ (see ROADMAP,
    # the ResNeSt pools)
    x = rng.normal(size=(2, SIZE, SIZE, 3)) * np.array([0.6, 1.4])[:, None, None, None] \
        + np.array([-0.3, 0.4])[:, None, None, None]
    off, stats_off, convs_off = _port(model, x, train, False, monkeypatch)
    on, stats_on, convs_on = _port(model, x, train, True, monkeypatch)
    assert convs_off - convs_on == _conv1x1_sites(model) > 0
    _close(on, off, 1e-12, "scope on against off")
    for k in stats_off:
        _close(stats_on[k], stats_off[k], 1e-12, f"running statistics {k}")
    with jax.enable_x64():
        want = _jax(kw, variables, x, train)
        if (encoder, train) not in JAX_TOL:
            floor = np.abs(off - _jax(kw, variables, x, train, einsum=False)).max()
            assert np.abs(on - want).max() <= 1.25 * floor, (np.abs(on - want).max(), floor)
            return
    _close(on, want, JAX_TOL[encoder, train], "port against JAX, both under the scope")
