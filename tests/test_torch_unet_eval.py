"""The port's whole eval step (normalize, 4-flip TTA, ResNet-50 UNetLoc,
fused tail, relayout, focal+dice, F1 state) against the JAX eval step on
the same weights (through ``weights.py``) and the same inputs.

Tolerances: float32 logits at rtol = atol = 2e-4, the JAX package's own
fused-vs-stock tolerance (tests/test_packed_fused_conv.py); the loss at
rtol 1e-5; the F1 counts equal.  bfloat16: max |diff| <= 0.05 * max|logit|
and >= 99% argmax agreement (the two frameworks round bf16 at other
places)."""

import jax
import numpy as np
import pytest
import torch

from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu.ops.metrics import init_f1_state as jax_init_f1
from xview2_tpu.parallel.steps import make_eval_step as jax_make_eval_step
from torch_jax_variables import jax_variables
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.ops.metrics import init_f1_state
from xview2_tpu_torch.parallel.steps import make_eval_step, resolve_device
from xview2_tpu_torch.weights import from_flax


def perturbed_variables(cfg_kw, seed=0, size=64):
    """Flax variables from the port's initializers (``jax_variables``: no
    flax init to trace) with BN statistics and affines drawn from a numpy
    seed and conv kernels scaled so activations stay O(1) through the
    network; the head bias is then set so both classes are predicted."""
    variables = jax_variables(cfg_kw, seed=seed)
    rng = np.random.default_rng(seed + 1)
    # centre the head: channel 1 wins on about half of a probe batch
    port = build_model(Config(**{**cfg_kw, "precision": 32}))
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    probe = torch.from_numpy(rng.normal(size=(2, size, size, 3)).astype(np.float32))
    with torch.inference_mode():
        logits = port(probe)
    margin = float(torch.median(logits[..., 1] - logits[..., 0]))
    head = variables["params"]["output_block"]["output_block"]["conv"]
    head["bias"] = head["bias"] + np.array([margin / 2, -margin / 2], head["bias"].dtype)
    return variables


def batch(seed=0, b=2, size=64):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, size, size, 3), np.uint8)
    masks = (rng.random((b, size, size)) > 0.8).astype(np.uint8)
    valid = np.ones((b,), np.float32)
    valid[-1] = 0.0  # a padded tail sample must not count
    return images, masks, valid


def _run_both(cfg_kw, variables, data):
    jcfg = JaxConfig(**cfg_kw)
    jstep = jax.jit(jax_make_eval_step(jcfg, jax_build_model(jcfg)))
    jf1, jloss, jlogits = jstep(variables["params"], variables["batch_stats"],
                                jax_init_f1(jcfg.n_metric_class), *data)
    cfg = Config(**cfg_kw)
    model = build_model(cfg)
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]),
                          strict=True)
    tf1, tloss, tlogits = make_eval_step(cfg, model, device="cpu")(
        init_f1_state(cfg.n_metric_class), *data)
    return (jf1, float(jloss), np.asarray(jlogits)), (tf1, float(tloss), tlogits.numpy())


@pytest.mark.parametrize("fused_tail,dilation", [(True, 1), (False, 1), (True, 2)],
                         ids=["fused", "stock", "fused-dilation2"])
def test_eval_step_f32_matches_jax(fused_tail, dilation):
    kw = dict(type="pre", encoder="resnet50", precision=32, tta=True, fused_tail=fused_tail,
              dilation=dilation)
    variables = perturbed_variables(kw)
    data = batch()
    (jf1, jloss, jlog), (tf1, tloss, tlog) = _run_both(kw, variables, data)
    assert tlog.shape == (2, 64, 64, 2) and tlog.dtype == np.float32
    assert 0.2 < (jlog.argmax(-1) == 1).mean() < 0.8  # both classes predicted
    np.testing.assert_allclose(tlog, jlog, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for name in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(getattr(tf1, name).numpy(), np.asarray(getattr(jf1, name)))


def test_eval_step_bf16_close_to_jax():
    kw = dict(type="pre", encoder="resnet50", precision=16, tta=True, fused_tail=True)
    variables = perturbed_variables(kw)
    (_, jloss, jlog), (_, tloss, tlog) = _run_both(kw, variables, batch(seed=1))
    assert np.isfinite(tlog).all()
    scale = np.abs(jlog).max()
    assert np.abs(tlog - jlog).max() <= 0.05 * scale
    assert (tlog.argmax(-1) == jlog.argmax(-1)).mean() >= 0.99


def test_fused_and_stock_paths_agree_in_the_port():
    """The port's fused tail against its own stock path (same weights)."""
    kw = dict(type="pre", encoder="resnet50", precision=32, tta=False)
    variables = perturbed_variables(kw, seed=3)
    images, masks, valid = batch(seed=2)
    outs = []
    for fused in (False, True):
        cfg = Config(**kw, fused_tail=fused)
        model = build_model(cfg)
        model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
        outs.append(make_eval_step(cfg, model, device="cpu")(
            init_f1_state(2), images, masks, valid)[2].numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-4, atol=2e-4)


def test_unported_options_raise():
    """Every option of the eval path is ported: ``--gpus 2``,
    ``--spatial_shards 2`` with a decoder option, ``--fold_eval_bn 0`` and
    the decoder options that raised here before they were ported pass the
    check and build and run, their logits the fine grid at eval, the packed
    loss view (or the DS list) in train mode."""
    from xview2_tpu_torch.train import trainer

    assert trainer._check_supported(Config(encoder="resnet50", gpus=2, spatial_shards=2,
                                           attention=True)) is None
    assert trainer._check_supported(Config(encoder="resnet50", gpus=2)) is None
    assert trainer._check_supported(Config(encoder="resnet50", gpus=2, spatial_shards=2)) is None
    assert trainer._check_supported(Config(encoder="resnet50", fold_eval_bn=False)) is None
    x = torch.zeros(1, 32, 32, 3)
    for kw in (dict(ppm=True, attention=True), dict(deep_supervision=True),
               dict(dec_interp=True, aspp=True, dilation=2)):
        model = build_model(Config(encoder="resnet50", precision=32, **kw))
        with torch.no_grad():
            assert model(x).shape == (1, 32, 32, 2), kw
            out = model(x, train=True)
        if kw.get("deep_supervision"):
            assert [o.shape for o in out] == [(1, 16, 64, 2), (1, 16, 16, 2), (1, 8, 8, 2)]
        else:
            assert out.shape == ((1, 32, 32, 2) if kw.get("dec_interp") else (1, 16, 64, 2))
    with torch.device("meta"):  # shapes only: the cross-fusion convs are 300 M parameters
        model = build_model(Config(type="post", dmg_model="fused", ppm=True, encoder="resnet50"))
    assert not any("ppm" in k for k in model.state_dict())
    # train mode: the logits come out in the packed loss view
    model = build_model(Config(encoder="resnet50", precision=32))
    assert model(torch.zeros(1, 64, 64, 3), train=True).shape == (1, 32, 128, 2)


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
