"""The port's ResNeSt encoders (``xview2_tpu_torch/models/resnest.py``)
against the JAX package's, module by module and as the encoder of a whole
``UNetLoc`` eval step, on the same weights (``weights.from_flax``) and the
same numpy inputs.

Tolerances: the modules run in float64 (``jax.enable_x64``), forward and
backward (the gradient of every parameter and of the input, by
``jax.vjp``), outputs, gradients and running statistics at 1e-6 of their
scale in eval mode.  Both packages round
to float32 at the same places (the pools' sums, the SplAt pooled map and its
radix weight), but the pooled map is a float32 MEAN, summed in another order
in each; in train mode ``bn1`` normalizes over the batch's few pooled values
and amplifies that ulp far beyond float64 rounding, so train mode is held at
1e-4.  The eval step as
``tests/test_torch_unet_eval.py`` holds the ResNet-50 one (logits at rtol =
atol = 2e-4, loss rtol 1e-5, F1 counts equal).  Parameter trees of all four
encoders equal by name and shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_variables import center_head, eval_batch, jax_variables, port_model
from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models import resnest as jrs
from xview2_tpu.models.layers import fold_eval_bn_scope
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu.ops.metrics import init_f1_state as jax_init_f1
from xview2_tpu.parallel.steps import make_eval_step as jax_make_eval_step
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models import resnest
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.ops.metrics import init_f1_state
from xview2_tpu_torch.parallel.steps import make_eval_step
from xview2_tpu_torch.weights import from_flax, to_flax


def _perturb(variables, seed):
    """BN statistics and affines away from the identity, kernels scaled;
    float64 leaves."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith("['kernel']"):
            return np.asarray(leaf, np.float64) * 1.7
        draws = {"['scale']": lambda: rng.uniform(0.5, 1.5, leaf.shape),
                 "['bias']": lambda: rng.normal(0, 0.1, leaf.shape),
                 "['mean']": lambda: rng.normal(0, 0.1, leaf.shape),
                 "['var']": lambda: rng.uniform(0.5, 2.0, leaf.shape)}
        for suffix, fn in draws.items():
            if key.endswith(suffix):
                return fn()
        return np.asarray(leaf, np.float64)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _module_case(jmod, tmod, x, train, seed=0):
    """One float64 forward and backward of the flax module (built with
    ``dtype=float64``) and its port on the same variables, the cotangent a
    random map: returns (jax, port) pairs of the output, the gradients (of
    the parameters and of the input, as flat ``{path: array}``) and the
    batch_stats after the call (train mode updates them)."""
    cot = np.random.default_rng(seed + 2)
    with jax.enable_x64():
        variables = _perturb(jax.device_get(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                                      True)), seed + 1)
        stats = variables["batch_stats"]

        def fwd(params, inp):
            with fold_eval_bn_scope(True):
                return jmod.apply({"params": params, "batch_stats": stats}, inp, train,
                                  mutable=["batch_stats"] if train else False)

        fwd = jax.jit(fwd)
        out, vjp, mutated = jax.vjp(fwd, variables["params"], jnp.asarray(x), has_aux=True) \
            if train else (*jax.vjp(fwd, variables["params"], jnp.asarray(x)), {})
        w = cot.normal(size=out.shape)
        gp, gx = vjp(jnp.asarray(w))
        jstats = jax.device_get(mutated.get("batch_stats", stats))
        jgrads = dict(_flat(jax.device_get(gp)), x=np.asarray(gx))
        jout = np.asarray(out)
    tmod = tmod.double()
    tmod.load_state_dict(from_flax(variables["params"], variables["batch_stats"]), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    tout = tmod(xt, train)
    names, params = zip(*tmod.named_parameters())
    grads = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), params + (xt,))
    tgrads = dict(_flat(to_flax(dict(zip(names, grads[:-1])))[0]), x=grads[-1].numpy())
    _, tstats = to_flax({k: v for k, v in tmod.state_dict().items() if "running" in k})
    return (jout, tout.detach().numpy()), (jgrads, tgrads), (jstats, tstats)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _check(case, train):
    """Outputs, every gradient and the running statistics of a module case
    within ``_tol(train)`` of their scale."""
    (jout, tout), (jgrads, tgrads), (jstats, tstats) = case
    tol = _tol(train)
    _close(tout, jout, tol)
    assert set(tgrads) == set(jgrads)
    for k, want in jgrads.items():
        _close(tgrads[k], want, tol)
    _stats_close(tstats, jstats, tol)


def _tol(train):
    return 1e-4 if train else 1e-6


def _close(got, want, tol):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-6))


def _stats_close(tstats, jstats, tol):
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tstats))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jstats))
    assert set(map(jax.tree_util.keystr, flat_t)) == set(map(jax.tree_util.keystr, flat_j))
    by_key = {jax.tree_util.keystr(k): v for k, v in flat_t.items()}
    for k, want in flat_j.items():
        want = np.asarray(want)
        np.testing.assert_allclose(by_key[jax.tree_util.keystr(k)], want, rtol=tol,
                                   atol=tol * np.abs(want).max(), err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("hw", [(8, 10), (9, 7)], ids=["even", "odd"])
@pytest.mark.parametrize("window,stride,padding,ceil_mode,cip", [
    (3, 2, 1, False, True),    # avd: count_include_pad
    (2, 2, 0, True, False),    # avg_down: ceil_mode, valid elements only
    (3, 2, 1, False, False)],  # padding excluded from the count
    ids=["avd", "avg-down", "exclude-pad"])
def test_avg_pool_matches_jax(window, stride, padding, ceil_mode, cip, hw):
    x = np.random.default_rng(0).normal(size=(2,) + hw + (5,)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=np.shape(
        jrs.avg_pool_torch(jnp.asarray(x), window, stride, padding, ceil_mode, cip)))
    want, vjp = jax.vjp(lambda v: jrs.avg_pool_torch(v, window, stride, padding, ceil_mode, cip),
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = resnest.avg_pool_torch(xt, window, stride, padding, ceil_mode, cip)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    (got * torch.from_numpy(w).float()).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(w, jnp.float32))[0]),
                               rtol=1e-6, atol=1e-6)
    # bfloat16 in, summed in float32, cast once
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = resnest.avg_pool_torch(xb, window, stride, padding, ceil_mode, cip)
    wb = jrs.avg_pool_torch(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), window, stride,
                            padding, ceil_mode, cip)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_array_equal(gb.float().numpy(), np.asarray(wb, np.float32))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("radix,card,stride,dilation", [(2, 1, 1, 1), (2, 1, 2, 2), (4, 1, 1, 1),
                                                        (2, 2, 1, 1)],
                         ids=["fast", "fast-s2-d2", "radix4", "card2"])
def test_splat_matches_jax(radix, card, stride, dilation, train):
    """The radix-2 fast path and the general grouped path, eval and train
    mode: output, gradients, running statistics of bn0 and of bn1 on the
    pooled 1x1 map."""
    ch, cin = 16, 16
    x = np.random.default_rng(1).normal(size=(3, 9, 11, cin))
    jmod = jrs.SplAtConv2d(ch, stride=stride, dilation=dilation, radix=radix, cardinality=card,
                           dtype=jnp.float64)
    tmod = resnest.SplAtConv2d(cin, ch, stride=stride, dilation=dilation, radix=radix,
                               cardinality=card, dtype=torch.float64)
    _check(_module_case(jmod, tmod, x, train), train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("stride,dilation,downsample,pool,is_first", [
    (1, 1, False, 1, False),   # a plain block
    (2, 1, True, 2, True),     # avd stride 2 and the avg_down pool (odd map: ceil mode)
    (1, 2, True, 1, True),     # a dilated stage's block 0: avd at stride 1, no pool
    (1, 2, False, 1, False)],  # dilated
    ids=["plain", "s2-avgdown", "d2-first", "d2"])
def test_bottleneck_matches_jax(stride, dilation, downsample, pool, is_first, train):
    planes, cin = 16, 64 if not downsample else 32
    x = np.random.default_rng(2).normal(size=(2, 9, 9, cin))
    jmod = jrs.ResNeStBottleneck(planes, stride=stride, dilation=dilation, downsample=downsample,
                                 downsample_pool_stride=pool, is_first=is_first,
                                 dtype=jnp.float64)
    tmod = resnest.ResNeStBottleneck(cin, planes, stride=stride, dilation=dilation,
                                     downsample=downsample, downsample_pool_stride=pool,
                                     is_first=is_first, dtype=torch.float64)
    case = _module_case(jmod, tmod, x, train)
    assert case[0][1].shape[1] == (5 if stride == 2 else 9)
    _check(case, train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_stem_matches_jax(train):
    x = np.random.default_rng(3).normal(size=(2, 17, 16, 3))
    case = _module_case(jrs.ResNeStStem(stem_width=8, dtype=jnp.float64),
                        resnest.ResNeStStem(3, 8, torch.float64), x, train)
    assert case[0][1].shape == (2, 9, 8, 16)
    _check(case, train)


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_stage_plan_matches_jax(dilation):
    for arch in resnest.RESNEST_LAYERS:
        assert resnest.resnest_stage_plan(arch, dilation) == list(
            jrs.resnest_stage_plan(arch, dilation))


def _run_eval_both(cfg_kw, variables, data):
    jcfg = JaxConfig(**cfg_kw)
    jstep = jax.jit(jax_make_eval_step(jcfg, jax_build_model(jcfg)))
    jf1, jloss, jlogits = jstep(variables["params"], variables["batch_stats"],
                                jax_init_f1(jcfg.n_metric_class), *data)
    cfg = Config(**cfg_kw)
    tf1, tloss, tlogits = make_eval_step(cfg, port_model(cfg_kw, variables), device="cpu")(
        init_f1_state(cfg.n_metric_class), *data)
    return (jf1, float(jloss), np.asarray(jlogits)), (tf1, float(tloss), tlogits.numpy())


def _eval_step_case(kw, seed=0, kernel_scale=2.2):
    variables = center_head(kw, jax_variables(kw, seed=seed, kernel_scale=kernel_scale))
    data = eval_batch(seed + 2, JaxConfig(**kw).in_channels)
    (jf1, jloss, jlog), (tf1, tloss, tlog) = _run_eval_both(kw, variables, data)
    assert tlog.shape == jlog.shape and tlog.dtype == np.float32
    assert np.isfinite(jlog).all() and 0.2 < (jlog.argmax(-1) == 1).mean() < 0.8
    np.testing.assert_allclose(tlog, jlog, rtol=2e-4, atol=2e-4 * max(1.0, np.abs(jlog).max()))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for name in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(getattr(tf1, name).numpy(), np.asarray(getattr(jf1, name)))


@pytest.mark.parametrize("fused_tail", [True, False], ids=["fused", "stock"])
def test_resnest50_unetloc_eval_step_f32_matches_jax(fused_tail):
    _eval_step_case(dict(type="pre", encoder="resnest50", precision=32, tta=True,
                         fused_tail=fused_tail))


@pytest.mark.parametrize("encoder", ["resnest50", "resnest101", "resnest200", "resnest269"])
def test_parameter_trees_match_jax(encoder):
    """``weights.to_flax`` of the port's state_dict has the JAX init's names
    and shapes, params and batch_stats alike (``jax.eval_shape``: nothing is
    computed): the localization model for each encoder, the Siamese one
    (the same template, another head) for ResNeSt-50."""
    kws = [dict(type="pre")]
    if encoder == "resnest50":
        kws.append(dict(type="post", dmg_model="siamese", loss_str="ohem+dice"))
    for kw in kws:
        jcfg = JaxConfig(encoder=encoder, precision=32, **kw)
        model = jax_build_model(jcfg)
        shapes = jax.eval_shape(lambda key, x: model.init(key, x, True), jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, jcfg.in_channels)))
        with torch.device("meta"):
            model = build_model(Config(encoder=encoder, precision=32, **kw))
        params, stats = to_flax({k: torch.zeros(()).expand(v.shape)
                                 for k, v in model.state_dict().items()})
        for got, want in ((params, shapes["params"]), (stats, shapes["batch_stats"])):
            g = {jax.tree_util.keystr(p): np.shape(v)
                 for p, v in jax.tree_util.tree_leaves_with_path(got)}
            w = {jax.tree_util.keystr(p): tuple(v.shape)
                 for p, v in jax.tree_util.tree_leaves_with_path(want)}
            assert g == w


@pytest.mark.slow
@pytest.mark.parametrize("fused_tail", [True, False], ids=["fused", "stock"])
def test_resnest200_unetloc_eval_step_f32_matches_jax(fused_tail):
    """The CLI's default encoder, whole: 66 blocks of the JAX and the port
    net on the same weights."""
    _eval_step_case(dict(type="pre", encoder="resnest200", precision=32, tta=False,
                         fused_tail=fused_tail), kernel_scale=1.9)
