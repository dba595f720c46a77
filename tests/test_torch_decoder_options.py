"""The decoder options of the port (``xview2_tpu_torch/models/layers.py``,
``models/unet.py``, ``ops/losses.py``): the resampling helpers, the
attention gate, ``--dec_interp``, PPM, ASPP, the fine and ``--interpolate``
heads and ``deep_supervision_loss``, module by module against the JAX
package's on the same weights (``weights.from_flax``) and the same numpy
inputs; the parameter trees of every variant under every option; the eval
steps of ``UNetLoc`` with the options.

Tolerances: the modules run in float64 (``jax.enable_x64``), forward and
backward (the gradient of every parameter and of every input by
``jax.vjp``), outputs, gradients and running statistics within 1e-9 of
their scale, in train mode (batch statistics) and at eval (the folded BN).
Trees equal by name and shape.  The eval steps as
``tests/test_torch_unet_eval.py`` holds the plain one: float32 logits at
rtol = atol = 2e-4, the loss at rtol 1e-5, the F1 counts equal; their
weights are the port's initial ones converted to flax variables
(``torch_jax_variables``), which costs no flax init trace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dmg_variants import _flax_shapes
from test_torch_unet_eval import batch
from torch_jax_variables import center_head, jax_variables, one_torch_thread  # noqa: F401
from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models import layers as jl
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu.ops.losses import deep_supervision_loss as jax_ds_loss
from xview2_tpu.ops.losses import make_loss_fn as jax_make_loss_fn
from xview2_tpu.ops.losses import packed_loss_view_labels as jax_packed_labels
from xview2_tpu.ops.metrics import init_f1_state as jax_init_f1
from xview2_tpu.parallel.steps import make_eval_step as jax_make_eval_step
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models import layers as tl
from xview2_tpu_torch.models.unet import DMG_UNETS, build_model
from xview2_tpu_torch.ops.losses import deep_supervision_loss, make_loss_fn
from xview2_tpu_torch.ops.losses import packed_loss_view_labels
from xview2_tpu_torch.ops.metrics import init_f1_state
from xview2_tpu_torch.parallel.steps import make_eval_step
from xview2_tpu_torch.weights import from_flax, to_flax

TOL = 1e-9
F64 = torch.float64


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


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
                 "['coral_bias']": lambda: rng.normal(0, 0.5, leaf.shape),
                 "['mean']": lambda: rng.normal(0, 0.1, leaf.shape),
                 "['var']": lambda: rng.uniform(0.5, 2.0, leaf.shape)}
        for suffix, fn in draws.items():
            if key.endswith(suffix):
                return fn()
        return np.asarray(leaf, np.float64)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _module_case(jmod, tmod, inputs, train, seed=0):
    """One float64 forward and backward of the flax module (``dtype`` float64)
    and of its port on the same variables and ``inputs``, the cotangent a
    random map; every output, gradient (parameters and inputs) and running
    statistic held within TOL of its scale."""
    cot = np.random.default_rng(seed + 2)
    tmod = tmod.double()
    # the flax variables from the port's tree (equal by name and shape, held by
    # the tree tests below): flax's init, traced op by op, would cost more than
    # the test
    params, stats = to_flax(tmod.state_dict())
    variables = _perturb({"params": params, "batch_stats": stats}, seed + 1)
    stats = variables["batch_stats"]
    with jax.enable_x64():
        jin = [jnp.asarray(a) for a in inputs]

        @jax.jit
        def fwd(params, *inp):
            with jl.fold_eval_bn_scope(True):
                out, mutated = jmod.apply({"params": params, "batch_stats": stats}, *inp, train,
                                          mutable=["batch_stats"])
            return out, mutated

        out, vjp, mutated = jax.vjp(fwd, variables["params"], *jin, has_aux=True)
        w = cot.normal(size=out.shape)
        gp, *gx = vjp(jnp.asarray(w))
        jgrads = dict(_flat(jax.device_get(gp)), **{f"x{i}": np.asarray(g)
                                                     for i, g in enumerate(gx)})
        jstats = _flat(jax.device_get(mutated.get("batch_stats", stats)))
        jout = np.asarray(out)
    tmod.load_state_dict(from_flax(variables["params"], stats), strict=True)
    xs = [torch.from_numpy(np.asarray(a, np.float64)).requires_grad_() for a in inputs]
    tout = tmod(*xs, train)
    names, params = zip(*tmod.named_parameters())
    grads = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), params + tuple(xs))
    tgrads = dict(_flat(to_flax(dict(zip(names, grads[:len(names)])))[0]),
                  **{f"x{i}": g for i, g in enumerate(grads[len(names):])})
    tstats = _flat(to_flax({k: v for k, v in tmod.state_dict().items() if "running" in k})[1])
    _close(tout, jout, "output")
    assert set(tgrads) == set(jgrads)
    for k, want in jgrads.items():
        _close(tgrads[k], want, f"gradient {k}")
    assert set(tstats) == set(jstats)
    for k, want in jstats.items():
        _close(torch.as_tensor(tstats[k]), want, f"batch_stats {k}")
    return tout


def _fn_case(jfn, tfn, x, seed=0):
    """A parameterless function in float64, forward and backward."""
    w = np.random.default_rng(seed).normal(size=np.shape(tfn(torch.from_numpy(x))))
    with jax.enable_x64():
        out, vjp = jax.vjp(jfn, jnp.asarray(x))
        gx, = vjp(jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    tout = tfn(xt)
    gt, = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), xt)
    _close(tout, np.asarray(out), "output")
    _close(gt, np.asarray(gx), "input gradient")


@pytest.mark.parametrize("hw,out_hw", [((5, 7), (10, 14)), ((1, 1), (6, 4)), ((6, 3), (1, 1)),
                                       ((8, 8), (8, 8)), ((16, 16), (512, 512))])
def test_interpolate_bilinear_matches_jax(hw, out_hw):
    """Align-corners bilinear resize in the matmul form, including 1 -> n
    and n -> 1 (the special cases of the weight matrix) and the identity."""
    x = np.random.default_rng(1).normal(size=(2, *hw, 3))
    _fn_case(lambda a: jl.interpolate_bilinear(a, out_hw),
             lambda a: tl.interpolate_bilinear(a, out_hw), x)


@pytest.mark.parametrize("size", [16, 7])
@pytest.mark.parametrize("bins", [1, 2, 3, 6])
def test_adaptive_avg_pool_matches_jax(size, bins):
    """torch's adaptive windows (overlapping where ``size % bins``) as an
    (out, in) averaging matrix."""
    x = np.random.default_rng(2).normal(size=(2, size, size + 1, 4))
    _fn_case(lambda a: jl.adaptive_avg_pool(a, (bins, bins)),
             lambda a: tl.adaptive_avg_pool(a, (bins, bins)), x)


def test_resampling_weights_round_in_bf16_like_jax():
    """In bfloat16 the weights themselves round (1/3, the align-corners
    fractions) before the products, as JAX casts them."""
    x = np.random.default_rng(3).normal(size=(1, 6, 6, 2)).astype(np.float32)
    for jfn, tfn in ((lambda a: jl.adaptive_avg_pool(a, (3, 3)),
                      lambda a: tl.adaptive_avg_pool(a, (3, 3))),
                     (lambda a: jl.interpolate_bilinear(a, (7, 11)),
                      lambda a: tl.interpolate_bilinear(a, (7, 11)))):
        want = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16)), np.float32)
        got = tfn(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
        exact = np.asarray(jfn(jnp.asarray(x, jnp.float32)))
        assert np.abs(got - exact).max() > 1e-4  # bf16 really rounds


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_attention_layer_matches_jax(train):
    x = np.random.default_rng(4).normal(size=(2, 6, 6, 8))
    _module_case(jl.AttentionLayer(4, dtype=jnp.float64), tl.AttentionLayer(8, 4, F64), [x],
                 train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("attention,dec_interp,skip", [
    (True, False, 12), (False, True, 12), (True, True, 12), (True, False, 0),
    (False, True, 0)], ids=["attention", "dec_interp", "both", "attention-noskip",
                            "dec_interp-fine-last"])
def test_upsample_block_matches_jax(attention, dec_interp, skip, train):
    """The attention gate on the skip, the ``--dec_interp`` upsample (3x3
    conv with bias, bilinear 2x), and the fine last stage (no skip, no
    gate: a ConvBlock on the upsampled map)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 5, 16))
    inputs = [x, rng.normal(size=(2, 8, 10, skip))] if skip else [x]
    jmod = jl.UpsampleBlock(8, skip, attention=attention, dec_interp=dec_interp,
                            dtype=jnp.float64)
    tmod = tl.UpsampleBlock(16, 8, skip, False, F64, attention=attention, dec_interp=dec_interp)
    if not skip:  # the flax call takes (x, skip, train); skip is None there
        jmod = _NoSkip(jmod)
    out = _module_case(jmod, _PortNoSkip(tmod) if not skip else tmod, inputs, train)
    assert out.shape == (2, 8, 10, 8)
    assert hasattr(tmod, "conv_o") == (attention and bool(skip))


class _NoSkip(jl.nn.Module):
    """A flax UpsampleBlock called as ``(x, None, train)``."""

    block: jl.nn.Module

    def __call__(self, x, train=False):
        return self.block(x, None, train)


class _PortNoSkip(torch.nn.Module):
    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x, train=False):
        return self.block(x, None, train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_ppm_matches_jax(train):
    """Bins 1, 2, 3 and 6 on a 7 x 9 map (uneven windows); the 1x1 bin is
    the ``in_size == 1`` case of the resize back."""
    x = np.random.default_rng(6).normal(size=(3, 7, 9, 16))
    out = _module_case(jl.PPM(dtype=jnp.float64), tl.PPM(16, F64), [x], train)
    assert out.shape == x.shape


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_aspp_matches_jax(dilation, train):
    """Dilations 1, 3d, 6d and 9d with padding = dilation: at d = 4 the
    36-dilated taps fall wholly in the padding of a 12 x 12 map."""
    x = np.random.default_rng(7).normal(size=(2, 12, 12, 16))
    out = _module_case(jl.ASPP(dilation=dilation, dtype=jnp.float64), tl.ASPP(16, dilation, F64),
                       [x], train)
    assert out.shape == x.shape


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("n_class,interpolate", [(4, False), (3, False), (1, False), (2, True),
                                                 (3, True)],
                         ids=["softmax", "coral", "mse", "softmax-interp", "coral-interp"])
def test_fine_output_block_matches_jax(n_class, interpolate, train):
    """The fine head: a 1x1 conv with bias, the CORAL logit without bias
    plus ``coral_bias``, and under ``interpolate`` the resize to a FIXED 512^2
    (train) or 1024^2 (eval) whatever the input size."""
    x = np.random.default_rng(8).normal(size=(1, 8, 8, 6))
    out = _module_case(jl.OutputBlock(n_class, interpolate=interpolate, dtype=jnp.float64),
                       tl.OutputBlock(n_class, 6, F64, packed=False, interpolate=interpolate),
                       [x], train)
    size = (512 if train else 1024) if interpolate else 8
    assert out.shape == (1, size, size, n_class)


@pytest.mark.parametrize("loss_str,task", [("focal+dice", "pre"), ("coral", "post")])
@pytest.mark.parametrize("packed", [False, True], ids=["fine", "main_labels"])
def test_deep_supervision_loss_matches_jax(loss_str, task, packed):
    """``loss(out) + 0.5 loss(ds4) + 0.25 loss(ds3)`` over nearest-downsampled
    fine labels, normalized by 1/(2 - 2^-3); with ``main_labels`` the main
    term reads the packed loss view.  Loss and the gradient of every
    output."""
    rng = np.random.default_rng(9)
    n = 3 if loss_str == "coral" else 2
    labels = rng.integers(0, 5 if task == "post" else 2, (2, 16, 16)).astype(np.int32)
    labels[0, :2, :3] = 255 if task == "post" else 1
    main = rng.normal(size=(2, 8, 32, n) if packed else (2, 16, 16, n))
    outs = [main, rng.normal(size=(2, 8, 8, n)), rng.normal(size=(2, 4, 4, n))]
    with jax.enable_x64():
        jfn = jax_make_loss_fn(loss_str, task)
        jmain = jax_packed_labels(jnp.asarray(labels)) if packed else None
        want, jg = jax.jit(jax.value_and_grad(
            lambda o: jax_ds_loss(jfn, o, jnp.asarray(labels), main_labels=jmain)))(
                [jnp.asarray(o) for o in outs])
    touts = [torch.from_numpy(o).requires_grad_() for o in outs]
    tmain = packed_loss_view_labels(torch.from_numpy(labels)) if packed else None
    got = deep_supervision_loss(make_loss_fn(loss_str, task), touts, torch.from_numpy(labels),
                                main_labels=tmain)
    assert got.item() == pytest.approx(float(want), rel=TOL)
    for g, w in zip(torch.autograd.grad(got, touts), jg):
        _close(g, w, "output gradient")


# ------------------------------------------------------------------ trees

OPTIONS = {"ppm": dict(ppm=True), "aspp": dict(aspp=True, dilation=2),
           "attention": dict(attention=True), "deep_supervision": dict(deep_supervision=True),
           "dec_interp": dict(dec_interp=True), "interpolate": dict(interpolate=True)}
# configuration D (BASELINE config 2) and config 4, and a mix of every option
COMBOS = {"D": dict(type="pre", encoder="resnest50", attention=True, deep_supervision=True,
                    autoaugment=True),
          "config4": dict(type="post", dmg_model="fused", encoder="resnest200",
                          loss_str="coral", ppm=True),
          "all": dict(type="pre", attention=True, deep_supervision=True, ppm=True,
                      dec_interp=True, dilation=4)}


def _jax_shapes(kw, size=64):
    jcfg = JaxConfig(**kw)
    jm = jax_build_model(jcfg)
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, size, size, jcfg.in_channels)), True))
    return {(col,) + tuple(k.key for k in p): tuple(leaf.shape)
            for col in ("params", "batch_stats")
            for p, leaf in jax.tree_util.tree_leaves_with_path(want.get(col, {}))}


def _port_shapes(kw):
    with torch.device("meta"):  # shapes only: the cross-fusion convs are 300 M parameters
        return _flax_shapes(build_model(Config(**kw)).state_dict())


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("model", ["pre"] + [pytest.param(m, marks=pytest.mark.slow)
                                             for m in DMG_UNETS])
def test_parameter_trees_match_jax(model, option):
    """``UNetLoc`` and the eight damage variants under each option: params
    and batch_stats equal to JAX's by name and shape (``jax.eval_shape``,
    nothing compiled), by the conventions of ``weights.to_flax``.  The
    damage variants' 48 cases (about 2 s each, flax's trace) are ``slow``, as
    their JAX twins' whole-network tests are; config 4's combination and the
    fused variants' indifference to ``--ppm`` stay in tier-1."""
    kw = dict(type="pre") if model == "pre" else dict(type="post", dmg_model=model,
                                                      loss_str="coral")
    kw = dict(kw, encoder="resnet50", **OPTIONS[option])
    assert _port_shapes(kw) == _jax_shapes(kw)


@pytest.mark.parametrize("combo", list(COMBOS))
def test_parameter_trees_of_combinations_match_jax(combo):
    kw = dict(dict(encoder="resnet50"), **COMBOS[combo])
    assert _port_shapes(kw) == _jax_shapes(kw)


def test_fused_variants_ignore_ppm_aspp_and_interpolate():
    """JAX's fused variants never read ``ppm``, ``aspp`` or ``interpolate``
    (xview2_tpu/models/unet.py:291-382): configuration C's tree IS config 4's."""
    for dmg_model in ("fused", "fusedEnc"):
        base = dict(type="post", dmg_model=dmg_model, encoder="resnet50", loss_str="coral")
        plain = _port_shapes(base)
        for extra in (dict(ppm=True), dict(aspp=True), dict(interpolate=True)):
            assert _port_shapes(dict(base, **extra)) == plain, (dmg_model, extra)


def test_new_leaves_round_trip_through_weights():
    """``weights.py`` needs no change: every new leaf (the gates' 1x1 kernels,
    the PPM and ASPP convs and BNs, the ``fuse``/``--dec_interp``/fine-head
    biases, the DS heads) is a 4-D kernel, a bias or a BN leaf, and
    ``from_flax(to_flax(sd))`` returns the state_dict exactly."""
    for kw in (dict(type="pre", attention=True, deep_supervision=True, ppm=True,
                    dec_interp=True),
               dict(type="post", dmg_model="parallelEnc", aspp=True, loss_str="coral",
                    deep_supervision=True),
               dict(type="post", dmg_model="siamese", interpolate=True)):
        sd = build_model(Config(encoder="resnet50", **kw)).state_dict()
        back = from_flax(*to_flax(sd))
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k


# ------------------------------------------------------------ eval steps

STEP_CASES = {"attention+ppm": dict(attention=True, ppm=True),
              "aspp-dilation2": dict(aspp=True, dilation=2),
              "dec_interp": dict(dec_interp=True),
              "interpolate": dict(interpolate=True)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_eval_step_with_options_matches_jax(case):
    """The whole eval step of a ResNet-50 ``UNetLoc`` with the option (TTA,
    the fused tail where a shape takes it) against JAX's.  Under
    ``--interpolate`` the logits are 1024^2 whatever the tile, so the masks
    are 1024^2 beside 64^2 images, as they are beside 1024^2 tiles."""
    kw = dict(type="pre", encoder="resnet50", precision=32, tta=True, fused_tail=True,
              **STEP_CASES[case])
    # the port's initial weights as flax variables (no flax init trace), BN
    # statistics and affines drawn, the head centred on a probe
    variables = center_head(kw, jax_variables(kw))
    images, masks, valid = batch()
    if case == "interpolate":
        masks = (np.random.default_rng(4).random((2, 1024, 1024)) > 0.8).astype(np.uint8)
    data = (images, masks, valid)
    jcfg = JaxConfig(**kw)
    jf1, jloss, jlog = jax.jit(jax_make_eval_step(jcfg, jax_build_model(jcfg)))(
        variables["params"], variables["batch_stats"], jax_init_f1(2), *data)
    cfg = Config(**kw)
    model = build_model(cfg)
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]), strict=True)
    tf1, tloss, tlog = make_eval_step(cfg, model, device="cpu")(init_f1_state(2), *data)
    jlog = np.asarray(jlog)
    assert tlog.shape == jlog.shape == masks.shape + (2,)
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for name in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(getattr(tf1, name).numpy(), np.asarray(getattr(jf1, name)))
