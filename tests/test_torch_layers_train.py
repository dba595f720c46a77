"""Train-mode BatchNorm of the port against the JAX modules it merges
(``TorchBatchNorm``, ``_PackedBN``, ``_PackedBNSums``): outputs, gradients
and running statistics after one call, in float32 and float64; then the
fused decoder blocks against the stock blocks in train mode, in the port.

Tolerances: float64 at 1e-9 of the leaf's scale (sums in another order);
float32 at 2e-4 of the scale for outputs and statistics and 2e-3 for
gradients (the BN-statistics gradient path cancels; the JAX package's own
fused-vs-stock tests use 2e-4 to 3e-4 on better-conditioned leaves).
``_PackedBN`` keeps float32 sums even for a float64 map, in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xview2_tpu.models import layers as jl
from xview2_tpu_torch.models import layers as tl

DTYPES = [("float32", 2e-4, 2e-3), ("float64", 1e-9, 1e-9)]


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=name)


def _bn_inputs(seed, c, shape, dtype):
    rng = np.random.default_rng(seed)
    return dict(
        x=(rng.normal(0.3, 1.5, size=shape)).astype(dtype),
        w=rng.normal(size=shape).astype(dtype),  # cotangent weights of the output
        scale=rng.uniform(0.5, 1.5, c).astype(dtype), bias=rng.normal(0, 0.3, c).astype(dtype),
        mean=rng.normal(0, 0.2, c).astype(dtype), var=rng.uniform(0.5, 2.0, c).astype(dtype))


def _port_bn(d, c, dtype):
    bn = tl.BatchNorm(c).to(getattr(torch, dtype))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(d["scale"]))
        bn.bias.copy_(torch.from_numpy(d["bias"]))
        bn.running_mean.copy_(torch.from_numpy(d["mean"]))
        bn.running_var.copy_(torch.from_numpy(d["var"]))
    return bn


def _jax_run(module, d, call):
    """value, grads (x, scale, bias) and new batch_stats of ``sum(y * w)``."""
    variables = {"params": {"scale": jnp.asarray(d["scale"]), "bias": jnp.asarray(d["bias"])},
                 "batch_stats": {"mean": jnp.asarray(d["mean"]), "var": jnp.asarray(d["var"])}}

    def loss(x, params):
        y, mut = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              *call(x), mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(d["w"])), (y, mut["batch_stats"])

    (_, (y, stats)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(d["x"]), variables["params"])
    return y, gx, gp, stats


def _check(bn, y, x, d, want, tol, gtol):
    jy, jgx, jgp, jstats = want
    gx, gs, gb = torch.autograd.grad((y * torch.from_numpy(d["w"])).sum(),
                                     (x, bn.weight, bn.bias))
    _close(y, jy, tol, "y")
    _close(bn.running_mean, jstats["mean"], tol, "running mean")
    _close(bn.running_var, jstats["var"], tol, "running var")
    _close(gx, jgx, gtol, "dx")
    _close(gs, jgp["scale"], gtol, "dscale")
    _close(gb, jgp["bias"], gtol, "dbias")


@pytest.mark.parametrize("dtype,tol,gtol", DTYPES)
def test_stock_bn_train_matches_torch_batchnorm_of_jax(dtype, tol, gtol):
    c, shape = 16, (3, 6, 5, 16)
    d = _bn_inputs(0, c, shape, dtype)
    with jax.enable_x64(dtype == "float64"):
        module = jl.TorchBatchNorm(use_running_average=False, momentum=jl.BN_MOMENTUM,
                                   epsilon=jl.BN_EPS, dtype=jnp.dtype(dtype),
                                   param_dtype=jnp.dtype(dtype))
        want = _jax_run(module, d, lambda x: (x,))
    bn = _port_bn(d, c, dtype)
    x = torch.from_numpy(d["x"]).requires_grad_()
    _check(bn, bn.normalize_train(x, x.dtype), x, d, want, tol, gtol)


def test_stock_bn_train_normalizes_bf16_in_f32_and_casts_once():
    """flax subtracts the f32 mean from the bf16 map, so train-mode stock BN
    normalizes in f32 and rounds once: at most half a bf16 ulp from the f32
    result (the eval fold rounds after each op and is further away)."""
    c, shape = 8, (2, 8, 8, 8)
    d = _bn_inputs(1, c, shape, "float32")
    bn = _port_bn(d, c, "float32")
    xb = torch.from_numpy(d["x"]).bfloat16()
    got = bn.normalize_train(xb, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _port_bn(d, c, "float32").normalize_train(xb.float(), torch.float32)
    assert torch.equal(got, want.bfloat16())
    module = jl.TorchBatchNorm(use_running_average=False, momentum=jl.BN_MOMENTUM,
                               epsilon=jl.BN_EPS, dtype=jnp.bfloat16)
    variables = {"params": {"scale": jnp.asarray(d["scale"]), "bias": jnp.asarray(d["bias"])},
                 "batch_stats": {"mean": jnp.asarray(d["mean"]), "var": jnp.asarray(d["var"])}}
    jy, _ = module.apply(variables, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                         mutable=["batch_stats"])
    assert jy.dtype == jnp.bfloat16
    # one bf16 ulp: XLA may fuse the f32 multiply-add differently
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(jy, np.float32), rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("dtype,tol,gtol", [("float32", 2e-4, 2e-3), ("float64", 1e-6, 1e-4)])
def test_packed_bn_train_matches_jax(dtype, tol, gtol):
    """f64 tolerances are f32-sized: ``_PackedBN`` sums in float32 whatever
    the map's dtype, so the two packages differ by f32 sum order there."""
    c, shape = 8, (2, 6, 5, 32)
    d = _bn_inputs(2, c, shape, dtype)
    with jax.enable_x64(dtype == "float64"):
        want = _jax_run(jl._PackedBN(c, dtype=jnp.dtype(dtype)), d, lambda x: (x, True))
    bn = _port_bn(d, c, dtype)
    x = torch.from_numpy(d["x"]).requires_grad_()
    _check(bn, bn.normalize_train_packed(x, x.dtype), x, d, want, tol, gtol)


@pytest.mark.parametrize("phases", [1, 4])
@pytest.mark.parametrize("dtype,tol,gtol", DTYPES)
def test_bn_from_sums_train_matches_jax(dtype, tol, gtol, phases):
    """``_PackedBNSums``: the fold from the fused kernel's sums, its running
    statistics, and the gradients flowing back through s1 and s2."""
    c, n = 8, 2 * 6 * 5 * phases
    rng = np.random.default_rng(3 + phases)
    d = _bn_inputs(4, c, (c,), dtype)
    vals = rng.normal(0.2, 1.0, size=(n // phases, phases * c)).astype(dtype)
    s1, s2 = vals.sum(0), (vals * vals).sum(0)
    w = [rng.normal(size=(phases * c,)).astype(dtype) for _ in range(3)]

    with jax.enable_x64(dtype == "float64"):
        variables = {"params": {"scale": jnp.asarray(d["scale"]), "bias": jnp.asarray(d["bias"])},
                     "batch_stats": {"mean": jnp.asarray(d["mean"]), "var": jnp.asarray(d["var"])}}
        module = jl._PackedBNSums(c, phases=phases)

        def loss(a, b, params):
            fold, mut = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     a, b, n, True, mutable=["batch_stats"])
            return sum(jnp.sum(f * jnp.asarray(wi)) for f, wi in zip(fold, w)), \
                (fold, mut["batch_stats"])

        (_, (jfold, jstats)), (g1, g2, gp) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(s1), jnp.asarray(s2),
                                                   variables["params"])
    bn = _port_bn(d, c, dtype)
    t1, t2 = torch.from_numpy(s1).requires_grad_(), torch.from_numpy(s2).requires_grad_()
    fold = bn.fold_from_sums(t1, t2, n, phases, True)
    got = torch.autograd.grad(sum((f * torch.from_numpy(wi)).sum() for f, wi in zip(fold, w)),
                              (t1, t2, bn.weight, bn.bias))
    for name, f, jf in zip(("mean", "mul", "bias"), fold, jfold):
        assert f.shape == (phases * c,)
        _close(f, jf, tol, name)
    _close(bn.running_mean, jstats["mean"], tol, "running mean")
    _close(bn.running_var, jstats["var"], tol, "running var")
    for name, g_, j_ in zip(("ds1", "ds2", "dscale", "dbias"), got,
                            (g1, g2, gp["scale"], gp["bias"])):
        _close(g_, j_, gtol, name)
    # eval: the fold comes from the running statistics, nothing is updated
    before = bn.running_var.clone()
    ef = bn.fold_from_sums(t1, t2, n, phases, False)
    assert torch.equal(bn.running_var, before) and torch.equal(ef[0][:c], bn.running_mean)


def _block_pair(kind, seed, cin, features, shape):
    torch.manual_seed(seed)
    make = {"packed": lambda: tl.PackedConvBlock(cin, features, torch.float64),
            "fine": lambda: tl.ConvBlock(cin, features, torch.float64)}[kind]
    stock = make().double()
    with torch.no_grad():
        for name, t in stock.state_dict().items():
            if name.endswith("running_var") or (name.endswith("weight") and t.dim() == 1):
                t.uniform_(0.5, 1.5)
            elif t.dim() == 1:
                t.normal_(0, 0.2)
    fused = make().double()
    fused.load_state_dict(stock.state_dict())
    x = torch.randn(shape, dtype=torch.float64)
    return stock, fused, x


@pytest.mark.parametrize("kind,cin,features,shape", [
    ("packed", 32, 32, (2, 16, 16, 128)), ("fine", 384, 128, (2, 16, 8, 384))])
def test_fused_block_matches_stock_block_in_train_mode(kind, cin, features, shape):
    """Same parameters, same input, float64: the fused chain (K2 forward, K4
    and K5 backward, here their plain versions) equals the stock block in
    output, every gradient and the updated running statistics.  The residual
    (1e-6 of scale) is the packed stock BN's float32 sums."""
    stock, fused, x = _block_pair(kind, 5, cin, features, shape)
    w = torch.sin(0.01 * torch.arange(x.numel() // x.shape[-1] * (4 if kind == "packed" else 1)
                                      * features, dtype=torch.float64))
    outs = []
    for block, scope in ((stock, False), (fused, True)):
        xin = x.clone().requires_grad_()
        with tl.fused_tail_scope(scope):
            y = block(xin, True)
        grads = torch.autograd.grad((y.reshape(-1) * w).sum(), [xin, *block.parameters()])
        outs.append((y, grads, block.state_dict()))
    (ys, gs, sds), (yf, gf, sdf) = outs
    tol = 1e-5
    _close(yf, ys.detach().numpy(), tol, "out")
    for i, (a, b) in enumerate(zip(gf, gs)):
        _close(a, b.numpy(), 10 * tol, f"grad {i}")
    for key in sds:
        if "running" in key:
            assert not torch.equal(sds[key], torch.ones_like(sds[key]))
            _close(sdf[key], sds[key].numpy(), tol, key)


def test_loss_view_is_a_pixel_permutation():
    from xview2_tpu.models.layers import unview_loss_logits as jax_unview
    from xview2_tpu.ops.losses import packed_loss_view_labels as jax_labels
    from xview2_tpu_torch.ops.losses import packed_loss_view_labels

    rng = np.random.default_rng(6)
    packed = rng.normal(size=(2, 4, 6, 8)).astype(np.float32)  # (B, H, W, 4n)
    view = torch.from_numpy(packed).reshape(2, 4, 24, 2)
    np.testing.assert_array_equal(tl.unview_loss_logits(view).numpy(),
                                  np.asarray(jax_unview(jnp.asarray(view.numpy()))))
    np.testing.assert_array_equal(tl.unview_loss_logits(view).numpy(),
                                  tl.depth_to_space(torch.from_numpy(packed)).numpy())
    labels = rng.integers(0, 2, (2, 8, 12)).astype(np.int32)
    np.testing.assert_array_equal(packed_loss_view_labels(torch.from_numpy(labels)).numpy(),
                                  np.asarray(jax_labels(jnp.asarray(labels))))
