"""Port weights mapping: flax tree -> torch state_dict -> flax tree is
bit-identical, and the mapped keys are exactly the port model's keys (the
CORAL head's ``coral_bias`` too)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.weights import from_flax, to_flax


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dilation", [1, 2])
def test_roundtrip_is_bit_identical_and_matches_model(dilation):
    kw = dict(type="pre", encoder="resnet50", precision=32, dilation=dilation)
    model = jax_build_model(JaxConfig(**kw))
    variables = jax.device_get(jax.jit(model.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), True))
    params, stats = variables["params"], variables["batch_stats"]

    sd = from_flax(params, stats)
    port = build_model(Config(**kw))
    assert set(sd) == set(port.state_dict()), \
        sorted(set(sd) ^ set(port.state_dict()))[:10]
    port.load_state_dict(sd, strict=True)

    back_p, back_s = to_flax(port.state_dict())
    for want, got in ((params, back_p), (stats, back_s)):
        want_l, got_l = _leaves(want), _leaves(got)
        assert set(want_l) == set(got_l)
        for k, v in want_l.items():
            assert got_l[k].dtype == v.dtype and got_l[k].shape == v.shape, k
            np.testing.assert_array_equal(got_l[k], v, err_msg=k)


def test_kernel_conventions():
    """HWIO <-> OIHW for convs and (kh, kw, out, in) <-> (in, out, kh, kw)
    for the transposed conv, without a flip."""
    rng = np.random.default_rng(0)
    conv = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    convt = rng.normal(size=(2, 2, 6, 7)).astype(np.float32)
    sd = from_flax({"a": {"Conv_0": {"kernel": conv}},
                    "conv_transpose": {"kernel": convt},
                    "bn": {"scale": np.ones(5, np.float32), "bias": np.zeros(5, np.float32)}},
                   {"bn": {"mean": np.zeros(5, np.float32), "var": np.ones(5, np.float32)}})
    assert sd["a.Conv_0.weight"].shape == (5, 4, 3, 3)
    assert float(sd["a.Conv_0.weight"][4, 3, 2, 1]) == conv[2, 1, 3, 4]
    assert sd["conv_transpose.weight"].shape == (7, 6, 2, 2)
    assert float(sd["conv_transpose.weight"][5, 4, 1, 0]) == convt[1, 0, 4, 5]
    assert set(sd) == {"a.Conv_0.weight", "conv_transpose.weight", "bn.weight", "bn.bias",
                       "bn.running_mean", "bn.running_var"}


def test_coral_bias_maps_both_ways():
    """The CORAL head's shared ordinal bias: a 1-D param named neither
    ``scale`` nor ``bias`` keeps its name in both directions, and a CORAL
    model's tree round-trips through ``load_state_dict``."""
    bias = np.array([0.9, 0.1, -1.2], np.float32)
    sd = from_flax({"output_block": {"output_block": {"coral_bias": bias}}}, {})
    assert set(sd) == {"output_block.output_block.coral_bias"}
    params, stats = to_flax(sd)
    np.testing.assert_array_equal(params["output_block"]["output_block"]["coral_bias"], bias)
    assert stats == {}
    port = build_model(Config(type="post", dmg_model="diff", encoder="resnet50",
                              loss_str="coral"))
    np.testing.assert_array_equal(
        port.state_dict()["unet.output_block.output_block.coral_bias"].numpy(), [1.0, 0.0, -1.0])
    params, stats = to_flax(port.state_dict())
    port.load_state_dict(from_flax(params, stats), strict=True)
    assert set(params["unet"]["output_block"]["output_block"]) == {"conv", "coral_bias"}
