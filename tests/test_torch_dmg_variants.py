"""The seven other damage variants of the port and what they add, against the
JAX package on the same weights (``weights.from_flax``) and the same numpy
inputs: the packed group conv (stock and fused), ``FusionBlock`` in its three
modes (encoder, decoder, the packed last stage by the stock route, the fused
route, and the fused route deferring its folds), the CORAL and MSE heads,
the parameter trees of all eight variants, the eval step of the seven new
ones, the ``--ckpt_pre`` transplant of each, and the CORAL and MSE dumps
(the train steps: ``test_torch_dmg_variants_train.py``).

Tolerances: modules in float64 at 1e-9 of each tensor's scale (sums in
another order), but the stock packed group conv at 1e-6 and its gradients
at 1e-4, because ``_PackedBN`` sums its statistics in float32 in both
packages (``test_torch_layers_train.py``); the eval step in float32 as
``test_torch_siamese.py`` holds the Siamese one: logits at 2e-4 of their
scale, the loss at rtol 1e-5, each F1 count equal up to the pixels that lie
within twice that tolerance of a decision boundary; parameter trees, the
transplant and the dumps exactly."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import _flat
from torch_jax_variables import (eval_batch, jax_variables,  # noqa: F401
                                 one_torch_thread, seeded_model)
from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models import layers as jl
from xview2_tpu.models.unet import DMG_UNETS as JAX_DMG_UNETS
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu.ops.metrics import init_f1_state as jax_init_f1
from xview2_tpu.parallel.steps import make_eval_step as jax_make_eval_step
from xview2_tpu.parallel.transplant import transplant_encoder as jax_transplant
from xview2_tpu.train import trainer as jax_trainer
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models import layers as tl
from xview2_tpu_torch.models.unet import DMG_UNETS, build_model
from xview2_tpu_torch.ops import packed_fused_conv as port_pfc
from xview2_tpu_torch.ops.metrics import init_f1_state
from xview2_tpu_torch.parallel.steps import make_eval_step
from xview2_tpu_torch.parallel.transplant import transplant_encoder
from xview2_tpu_torch.train import trainer as port_trainer
from xview2_tpu_torch.weights import from_flax, to_flax

F64 = jnp.float64


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def _perturb(variables, seed):
    """BN statistics and affines drawn away from the identity, so the folds
    and the train-mode normalization do real work."""
    rng = np.random.default_rng(seed)
    draws = {"scale": lambda s: rng.uniform(0.5, 1.5, s), "bias": lambda s: rng.normal(0, 0.1, s),
             "mean": lambda s: rng.normal(0, 0.1, s), "var": lambda s: rng.uniform(0.5, 2.0, s)}

    def draw(path, leaf):
        name = path[-1].key
        return draws[name](leaf.shape) if name in draws else np.asarray(leaf, np.float64)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(variables))


def _load(module, variables):
    module.double().load_state_dict(
        from_flax(variables["params"], variables.get("batch_stats", {})), strict=True)
    return module


def _j_out(o):
    """A JAX module output as (activated map, (raw, fold) or None)."""
    if isinstance(o, jl.DeferredFold):
        raw, fold = jl.consume_fold(o)
        return jl._norm_act(raw, *fold, act="leaky"), (raw, fold)
    return o, None


def _t_out(o):
    if isinstance(o, tl.DeferredFold):
        raw, fold = tl.consume_fold(o)
        return tl.norm_act(raw, *fold, act="leaky"), (raw, fold)
    return o, None


def _run_jax(module, variables, inputs, kwargs, train, scope, cot):
    """Outputs (activated, and raw + fold where deferred), the gradients of
    ``sum(out_i * cot_i)`` with respect to the parameters and the inputs (in
    train mode), and the new running statistics; ``cot=None``: the outputs'
    shapes only (``jax.eval_shape``)."""
    def fn(params, *xs):
        with jl.fused_tail_scope(*scope):
            outs, mut = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     *xs, **kwargs, train=train, mutable=["batch_stats"])
            outs = [_j_out(o) for o in outs]
        loss = 0.0 if cot is None else sum(jnp.sum(a * c) for (a, _), c in zip(outs, cot))
        return loss, (outs, mut["batch_stats"])

    xs = [jnp.asarray(x) for x in inputs]
    if cot is None:
        return jax.eval_shape(fn, variables["params"], *xs)[1][0]
    if not train:
        return jax.jit(fn)(variables["params"], *xs)[1][0], None, None, None
    (_, (outs, stats)), grads = jax.jit(jax.value_and_grad(
        fn, argnums=tuple(range(len(xs) + 1)), has_aux=True))(variables["params"], *xs)
    return outs, grads[0], grads[1:], stats


def _check_module(module, variables, inputs, kwargs, train, scope, tol, gtol, deferred=False):
    """The port module against the JAX module's ``_run_jax`` results."""
    rng = np.random.default_rng(5)
    with jax.enable_x64():
        jmod, jvars = module
        probe = _run_jax(jmod, jvars, inputs, kwargs, train, scope, None)
        cot = [rng.normal(size=a.shape) for a, _ in probe]
        want, jgp, jgx, jstats = _run_jax(jmod, jvars, inputs, kwargs, train, scope, cot)
    port = variables
    xs = [torch.from_numpy(np.asarray(x)).requires_grad_(train) for x in inputs]
    with tl.fused_tail_scope(scope[0], defer_head=scope[2]):
        outs = [_t_out(o) for o in port(*xs, **kwargs, train=train)]
    for i, ((a, rf), (wa, wrf)) in enumerate(zip(outs, want)):
        assert (rf is not None) == (wrf is not None) == deferred, i
        _close(a, wa, tol, f"output {i}")
        if rf is not None:
            _close(rf[0], wrf[0], tol, f"raw output {i}")
            for k in range(3):
                _close(rf[1][k], wrf[1][k], tol, f"fold {k} of output {i}")
    if not train:
        return
    loss = sum((a * torch.from_numpy(c)).sum() for (a, _), c in zip(outs, cot))
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, list(params) + xs)
    got = _flat(to_flax(dict(zip(names, grads[:len(params)])))[0])
    want_g = _flat(jax.device_get(jgp))
    assert set(got) == set(want_g)
    for k, w in want_g.items():
        _close(got[k], w, gtol, f"gradient {k}")
    for i, (g, w) in enumerate(zip(grads[len(params):], jgx)):
        _close(g, w, gtol, f"input gradient {i}")
    got_s = _flat(to_flax({k: v for k, v in port.state_dict().items() if "running" in k})[1])
    want_s = _flat(jax.device_get(jstats))
    assert set(got_s) == set(want_s)
    for k, w in want_s.items():
        _close(got_s[k], w, tol, f"running statistic {k}")


def _init(jmod, inputs, kwargs, seed):
    with jax.enable_x64():
        variables = jmod.init(jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in inputs],
                              **kwargs, train=False)
    return _perturb(variables, seed + 1)


class _Pair(torch.nn.Module):
    """Calls a FusionBlock and returns its two outputs as a list."""

    def __init__(self, fb):
        super().__init__()
        self.fb = fb

    def forward(self, *xs, train=False, **kwargs):
        return list(self.fb(*xs, train=train, **kwargs))


class _JPair(fnn.Module):
    fb: fnn.Module

    def __call__(self, *xs, train=False, **kwargs):
        return list(self.fb(*xs, train=train, **kwargs))


def _fusion_case(mode):
    """(JAX FusionBlock, port FusionBlock, inputs, kwargs) with stand-in
    sub-layers: ConvLayers (encoder), fine UpsampleBlocks with skips
    (decoder), packed UpsampleBlocks of 32 fine channels (the last stage:
    2 x 128 packed channels, the cross-fusion's shape)."""
    rng = np.random.default_rng(3)
    if mode == "encoder":
        f = 16
        subs = [jl.ConvLayer(f, dtype=F64) for _ in range(2)], \
            [tl.ConvLayer(8, f, torch.float64) for _ in range(2)]
        inputs = [rng.normal(size=(2, 12, 10, 8)) for _ in range(2)]
        kw = dict(features=f)
    elif mode == "decoder":
        f = 16
        subs = [jl.UpsampleBlock(f, 8, dtype=F64) for _ in range(2)], \
            [tl.UpsampleBlock(24, f, 8, False, torch.float64) for _ in range(2)]
        inputs = [rng.normal(size=(2, 6, 5, 24)) for _ in range(2)] + \
            [rng.normal(size=(2, 12, 10, 8)) for _ in range(2)]
        kw = dict(features=f, decoder_mode=True)
    else:
        f = 32
        subs = [jl.UpsampleBlock(f, 0, packed_out=True, dtype=F64) for _ in range(2)], \
            [tl.UpsampleBlock(24, f, 0, True, torch.float64) for _ in range(2)]
        inputs = [rng.normal(size=(2, 16, 8, 24)) for _ in range(2)]
        kw = dict(features=f, decoder_mode=True, packed_last=True)
    jfb = _JPair(jl.FusionBlock(pre_layer=subs[0][0], post_layer=subs[0][1], dtype=F64, **kw))
    tfb = _Pair(tl.FusionBlock(subs[1][0], subs[1][1], dtype=torch.float64, **kw))
    call_kw = {"last_dec": True} if mode == "packed" else {}
    return jfb, tfb, inputs, call_kw


# (mode, scope (fused tail, mesh, defer), deferred outputs)
FUSION_CASES = {
    "encoder": ("encoder", (False, None, False), False),
    "decoder": ("decoder", (True, None, True), False),
    "packed-stock": ("packed", (False, None, False), False),
    "packed-fused": ("packed", (True, None, False), False),
    "packed-fused-deferred": ("packed", (True, None, True), True),
}


@pytest.mark.parametrize("case,train", [
    pytest.param(c, t, id=f"{c}-{'train' if t else 'eval'}") for c, t in (
        ("encoder", True), ("decoder", True), ("packed-stock", True),
        ("packed-fused-deferred", True), ("packed-stock", False), ("packed-fused", False),
        ("packed-fused-deferred", False))])
def test_fusion_block_matches_jax(case, train):
    """``FusionBlock`` forward (and in train mode backward and running
    statistics) in float64: the encoder and decoder modes re-mix with stock
    ConvLayers (the decoder's sub-layers are fused ConvBlocks where they take
    the route, not here at 16 channels); the packed last stage runs its two
    group convs by the stock route, by the fused route on one raw concat
    with its concatenated fold, or deferring both folds to the head."""
    mode, scope, deferred = FUSION_CASES[case]
    jfb, tfb, inputs, kw = _fusion_case(mode)
    variables = _init(jfb, inputs, kw, seed=11)
    port = _load(tfb, variables)
    stock_packed = mode == "packed" and not scope[0]
    tol = 1e-6 if stock_packed else 1e-9
    gtol = 1e-4 if stock_packed else 1e-9
    launches = port_pfc.conv_bn_fused.launches
    _check_module((jfb, variables), port, inputs, kw, train, scope, tol, gtol, deferred)
    assert port_pfc.conv_bn_fused.launches == launches  # the CPU runs the plain versions


@pytest.mark.parametrize("route", ["stock", "fused"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_packed_group_conv_matches_jax(train, route):
    """``PackedConvLayer(groups=2)`` against JAX ``PackedGroupConvLayer``
    (stock) and ``_FusedPackedConvLayer(groups=2)`` (``forward_fused``: the
    raw output and its fold), float64, on the group-major concat of two
    packed branches of 8 fine channels."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 8, 64))
    layer = tl.PackedConvLayer(16, 8, torch.float64, groups=2)
    if route == "stock":
        jmod = _JList(jl.PackedGroupConvLayer(8, 2, dtype=F64))
        variables = _init(jmod, [x], {}, seed=12)
        _check_module((jmod, variables), _load(_List(layer), variables), [x], {}, train,
                      (False, None, False), 1e-6, 1e-4)
        return
    fold = tuple(rng.normal(size=64) * s + o for s, o in ((0.3, 0), (0.3, 1), (0.3, 0)))
    n = 2 * 16 * 8 * 4
    jmod = jl._FusedPackedConvLayer(8, dtype=F64, groups=2)
    with jax.enable_x64():
        jf = tuple(jnp.asarray(v) for v in fold)
        variables = _perturb(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), jf, True, n, False,
                                       None), 13)
        (jout, jfold), mut = jmod.apply(variables, jnp.asarray(x), jf, True, n, train, None,
                                        mutable=["batch_stats"])
    port = _load(layer, variables)
    out, tfold = port.forward_fused(torch.from_numpy(x), tuple(torch.from_numpy(v) for v in fold),
                                    True, n, train)
    _close(out, jout, 1e-9, "raw output")
    for k in range(3):
        _close(tfold[k], jfold[k], 1e-9, f"fold {k}")
    got = _flat(to_flax({k: v for k, v in port.state_dict().items() if "running" in k})[1])
    for k, w in _flat(jax.device_get(mut["batch_stats"])).items():
        _close(got[k], w, 1e-9, k)
    wp = port.packed_kernel()
    assert wp.shape == (3, 3, 64, 32)
    np.testing.assert_array_equal(  # group-major rows: [g, p, c]
        wp.reshape(3, 3, 2, 4, 8, 32)[:, :, 1, 0].detach().numpy(),
        tl.s2d_conv_kernel(tl.hwio(port.Conv_0.weight)).reshape(3, 3, 4, 2, 8, 32)[:, :, 0, 1]
        .detach().numpy())


class _List(torch.nn.Module):
    """Calls a layer and returns its output as a list of one."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, x, train=False):
        return [self.layer(x, train)]


class _JList(fnn.Module):
    layer: fnn.Module

    def __call__(self, x, train=False):
        return [self.layer(x, train)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("n_class,groups", [(3, 1), (3, 2), (1, 1), (1, 2)],
                         ids=["coral", "coral-2", "mse", "mse-2"])
def test_coral_and_mse_heads_match_jax(n_class, groups, fused, train):
    """The packed ``OutputBlock`` with one logit, float64: the CORAL head (no
    bias; ``coral_bias`` after depth-to-space at eval, on the loss view in
    train mode, broadcasting 1 -> 3 channels) and the MSE head (its bias),
    over one or two packed branches, with the activated input or a deferred
    fold (the fused head, a zero bias for CORAL)."""
    rng = np.random.default_rng(6)
    c = 4 * 16 * groups
    x = rng.normal(size=(2, 8, 6, c))
    fold = tuple(rng.normal(size=c) * 0.3 + o for o in (0.0, 1.0, 0.0))
    jmod = jl.OutputBlock(n_class, packed_in=True, packed_groups=groups, emit_loss_view=True,
                          dtype=F64)
    with jax.enable_x64():
        variables = jax.device_get(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), False))
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64) +
                                        rng.normal(0, 0.2, a.shape), variables["params"])
        if n_class == 3:
            assert set(params) == {"conv", "coral_bias"} and set(params["conv"]) == {"kernel"}

        def run(p, x):
            with jl.fused_tail_scope(fused, None, defer_head=fused):
                arg = jl.defer_fold(x, tuple(jnp.asarray(v) for v in fold)) if fused else x
                return jmod.apply({"params": p}, arg, train)

        want = run(params, jnp.asarray(x))
        cot = rng.normal(size=want.shape)
        jg = jax.grad(lambda p, x: jnp.sum(run(p, x) * cot), argnums=(0, 1))(params,
                                                                            jnp.asarray(x))
    port = _load(tl.OutputBlock(n_class, 16 * groups, torch.float64, groups), {"params": params})
    xt = torch.from_numpy(x).requires_grad_()
    with tl.fused_tail_scope(fused, defer_head=fused):
        arg = tl.defer_fold(xt, tuple(torch.from_numpy(v) for v in fold)) if fused else xt
        got = port(arg, train)
    assert got.shape == want.shape == ((2, 8, 24, n_class) if train else (2, 16, 12, n_class))
    _close(got, want, 1e-9, "logits")
    names, ps = zip(*port.named_parameters())
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), list(ps) + [xt])
    gp = _flat(to_flax(dict(zip(names, grads[:-1])))[0])
    for k, w in _flat(jax.device_get(jg[0])).items():
        _close(gp[k], w, 1e-9, f"gradient {k}")
    _close(grads[-1], jg[1], 1e-9, "input gradient")


# one loss per variant, so that the trees hold both new heads
TREE_CASES = [("siamese", "ohem+dice"), ("siameseEnc", "coral"), ("fused", "coral"),
              ("fusedEnc", "mse"), ("parallel", "coral"), ("parallelEnc", "ohem+dice"),
              ("diff", "mse"), ("cat", "ohem+dice")]


@pytest.mark.parametrize("dmg_model,loss_str", TREE_CASES)
def test_parameter_trees_match_jax(dmg_model, loss_str):
    """Every variant's params and batch_stats equal to JAX's by name and
    shape (``jax.eval_shape`` of the flax init, nothing compiled)."""
    kw = dict(type="post", dmg_model=dmg_model, encoder="resnet50", loss_str=loss_str)
    jm = jax_build_model(JaxConfig(**kw))
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)),
                                          False))
    want = {(col,) + tuple(k.key for k in p): tuple(leaf.shape)
            for col in ("params", "batch_stats")
            for p, leaf in jax.tree_util.tree_leaves_with_path(want[col])}
    with torch.device("meta"):  # shapes only: the cross-fusion convs are 300 M parameters
        model = build_model(Config(**kw))
    assert _flax_shapes(model.state_dict()) == want


def _flax_shapes(state_dict):
    """The flax path and shape of each ``state_dict`` entry, by the
    conventions of ``weights.to_flax`` (held in ``test_torch_weights.py``)."""
    out = {}
    for name, t in state_dict.items():
        *mods, leaf = name.split(".")
        shape = tuple(t.shape)
        if leaf in ("running_mean", "running_var"):
            path = ("batch_stats", *mods, leaf.split("_")[1])
        elif leaf == "weight" and len(shape) == 4:
            path, shape = ("params", *mods, "kernel"), tuple(shape[i] for i in (2, 3, 1, 0))
        else:
            path = ("params", *mods, {"weight": "scale"}.get(leaf, leaf))
        out[path] = shape
    return out


def test_every_variant_and_loss_is_supported():
    """The fit checks take all eight variants with ``ohem+dice``, ``coral``
    and ``mse``, and ``--autoaugment``; the factory maps each name to the
    class of the JAX package's name (their trees:
    ``test_parameter_trees_match_jax``).  ``fused`` with ``--ppm``, config 4
    as written, builds too: the fused variants ignore ``--ppm``, as JAX's do
    (``tests/test_torch_decoder_options.py`` holds the trees equal)."""
    for dmg_model in DMG_UNETS:
        for loss_str in ("ohem+dice", "coral", "mse"):
            port_trainer._check_fit_supported(Config(type="post", dmg_model=dmg_model,
                                                     loss_str=loss_str, autoaugment=True))
    assert {k: v.__name__ for k, v in DMG_UNETS.items()} == \
        {k: v.__name__ for k, v in JAX_DMG_UNETS.items()}
    cfg = Config(type="post", dmg_model="fused", ppm=True, encoder="resnet50")
    port_trainer._check_fit_supported(cfg)
    with torch.device("meta"):
        assert not any(k.startswith("ppm") for k in build_model(cfg).state_dict())


def _boundary_pixels(logits, loss_str, tol):
    """Pixels whose decision lies within ``tol`` of a boundary: the two
    largest class logits (softmax heads), a level logit near 0 (CORAL), the
    regression near a rounding edge (MSE)."""
    if loss_str == "coral":
        return (np.abs(logits) <= tol).any(-1)
    if loss_str == "mse":
        v = np.maximum(logits[..., 0], 0)
        return np.abs(v - np.floor(v) - 0.5) <= tol
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] <= tol


def _center_head(kw, model, variables):
    """Shift the head so that the variant predicts every damage class at
    some pixels: the softmax bias by each class's median logit; CORAL's
    ordinal bias to the quartiles of its logit; MSE's bias to put the median
    regression at 1.5.  Changes ``model`` and ``variables`` alike."""
    probe = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 64, 64, 6))).float()
    with torch.inference_mode():
        flat = model(probe).double().numpy().reshape(-1, Config(**kw).n_class)
    root = variables["params"]
    root = root["unet"] if kw["dmg_model"] in ("diff", "cat") else root
    head = root["output_block"]["output_block"]
    if kw["loss_str"] == "coral":
        raw = flat[:, 0] - head["coral_bias"][0]
        head["coral_bias"] = -np.quantile(raw, [0.25, 0.5, 0.75]).astype(np.float32)
    elif kw["loss_str"] == "mse":
        head["conv"]["bias"] = (head["conv"]["bias"] - np.median(flat[:, 0]) + 1.5
                                ).astype(np.float32)
    else:
        head["conv"]["bias"] = (head["conv"]["bias"] - np.median(flat, axis=0)).astype(np.float32)
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))


# configuration C's variant and head, and the MSE head, in tier-1; the other
# five whole-network parities are slow, as the ROADMAP's ground rules ask
EVAL_CASES = [("fused", "coral"), ("cat", "mse")] + [
    pytest.param(v, "ohem+dice", marks=pytest.mark.slow)
    for v in ("siameseEnc", "fusedEnc", "parallel", "parallelEnc", "diff")]


@pytest.mark.parametrize("dmg_model,loss_str", EVAL_CASES)
def test_eval_step_f32_matches_jax(dmg_model, loss_str):
    """The whole eval step of each new variant (ResNet-50, 64^2, 4-flip TTA,
    fused tail) in float32: logits, loss and F1 counts, the fused variant
    with the CORAL head and cat with the MSE head."""
    kw = dict(type="post", dmg_model=dmg_model, loss_str=loss_str, encoder="resnet50",
              precision=32, tta=True, fused_tail=True)
    model, variables = seeded_model(kw, seed=4)
    _center_head(kw, model, variables)
    data = eval_batch(6, 6)
    jcfg = JaxConfig(**kw)
    jf1, jloss, jlog = jax.jit(jax_make_eval_step(jcfg, jax_build_model(jcfg)))(
        variables["params"], variables["batch_stats"], jax_init_f1(5), *data)
    jlog = np.asarray(jlog)
    tf1, tloss, tlog = make_eval_step(Config(**kw), model, device="cpu")(init_f1_state(5), *data)
    tlog = tlog.numpy()
    assert tlog.shape == (2, 64, 64, Config(**kw).n_class) and np.isfinite(jlog).all()
    scale = max(1.0, np.abs(jlog).max())
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    counted = (data[1] > 0) & (data[2][:, None, None] > 0)
    ties = int((_boundary_pixels(jlog, loss_str, 4e-4 * scale) & counted).sum())
    assert ties <= 0.01 * counted.sum()
    for name in ("tp", "fp", "fn"):
        diff = np.abs(getattr(tf1, name).numpy() - np.asarray(getattr(jf1, name)))
        assert diff.max() <= ties, (name, diff, ties)


@pytest.fixture(scope="module")
def localization():
    """A localization model's flax variables (ResNet-50, statistics drawn
    from a seed) and the same as a port ``state_dict``."""
    loc = jax_variables(dict(type="pre", encoder="resnet50", precision=32), seed=5)
    return loc, from_flax(loc["params"], loc["batch_stats"])


@pytest.mark.parametrize("dmg_model", ["siameseEnc", "fused", "fusedEnc", "parallel",
                                       "parallelEnc", "diff", "cat"])
def test_transplant_matches_jax(dmg_model, localization):
    """``--ckpt_pre`` places the localization encoder where JAX's
    ``transplant_encoder`` places it (both branches of ``parallel``,
    ``parallelEnc``, ``fused`` and ``fusedEnc``), params and running
    statistics, and ``cat``'s 6-channel stem keeps its own value."""
    loc, loc_state = localization
    model = build_model(Config(type="post", dmg_model=dmg_model, loss_str="ohem+dice",
                               encoder="resnet50"))
    params, stats = to_flax(model.state_dict())
    want_p, want_s = jax_transplant(dmg_model, params, stats, loc["params"], loc["batch_stats"])
    stem = "unet.unet.enc_l1.conv1.weight"
    before = model.state_dict()[stem].clone() if dmg_model == "cat" else None
    copied = transplant_encoder(dmg_model, model, loc_state)
    n_loc = sum(1 for k in loc_state if ".enc_l" in k)
    branches = 2 if dmg_model in ("fused", "fusedEnc", "parallel", "parallelEnc") else 1
    assert len(copied) == branches * n_loc - (dmg_model == "cat")
    # the JAX transplant returns the target's own leaf where it copies nothing:
    # the port must have copied exactly the leaves JAX replaced, with its values
    sd = model.state_dict()
    got_p, got_s = to_flax({k: sd[k] for k in copied})
    for got, want, old in ((got_p, want_p, params), (got_s, want_s, stats)):
        old = {jax.tree_util.keystr(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(old)}
        replaced = {jax.tree_util.keystr(p): np.asarray(leaf)
                    for p, leaf in jax.tree_util.tree_leaves_with_path(want)
                    if leaf is not old[jax.tree_util.keystr(p)]}
        g = _flat(got)
        assert set(g) == set(replaced)
        for k, w in replaced.items():
            np.testing.assert_array_equal(g[k], w, err_msg=k)
    if dmg_model == "cat":
        assert stem not in copied and torch.equal(model.state_dict()[stem], before)


@pytest.mark.parametrize("loss_str", ["coral", "mse"])
def test_coral_and_mse_dumps_match_jax(loss_str, tmp_path):
    """The damage dumps of ``--loss_str coral`` (``count(sigmoid > 0.5) +
    1``) and ``mse`` (``round(max(logit, 0)) + 1``): (H, W) float32 files
    equal to JAX ``_save_predictions``'s, a padded sample skipped."""
    rng = np.random.default_rng(9)
    n = 3 if loss_str == "coral" else 1
    logits = rng.normal(0, 2, (3, 16, 12, n)).astype(np.float32)
    logits[0, 0, :4, 0] = [0.5, 1.5, 2.5, -0.5]  # exact halves round to even
    targets = rng.integers(0, 5, (3, 16, 12)).astype(np.uint8)
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    out = {}
    for name, save, arr in (("jax", jax_trainer._save_predictions, jnp.asarray(logits)),
                            ("port", port_trainer._save_predictions, torch.from_numpy(logits))):
        res = tmp_path / name
        cfg = (JaxConfig if name == "jax" else Config)(type="post", loss_str=loss_str,
                                                      results=str(res))
        assert save(cfg, arr, targets, valid, 0) == 2
        out[name] = [np.load(res / "probs" / f"test_damage_{i:05d}.npy") for i in range(2)]
    for got, want in zip(out["port"], out["jax"]):
        assert got.shape == (16, 12) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    if loss_str == "coral":
        assert set(np.unique(np.concatenate(out["port"]))) <= {1.0, 2.0, 3.0, 4.0}
