"""The backward of the port's fused conv+BN (K4 wgrad, K5 dgrad) and fused
head on the CPU (their plain versions) against the JAX package: the Pallas
backward kernels in interpret mode, and ``jax.vjp`` of ``conv_bn_fused`` /
``head_conv_fused`` with cotangents on every output.

Tolerances.  float32: rtol 1e-4 and atol 1e-4 of the leaf's scale, the JAX
kernel test's own (sums in another order).  bfloat16: ``dW`` stays f32 in
both packages and differs by the sum order and by XLA's excess precision in
the prologue (rtol 2e-2 of the scale, the JAX bf16 forward test's own);
``dx`` carries one rounding of its dtype on top (atol 2e-2 of the scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xview2_tpu.ops.packed_fused_conv as pfc
from xview2_tpu_torch.ops import packed_fused_conv as port


@pytest.fixture(autouse=True)
def _interpret():
    pfc.INTERPRET = True
    yield
    pfc.INTERPRET = False


def _case(seed, b=2, h=16, w=8, c=128, co=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    g = rng.normal(size=(b, h, w, co)).astype(np.float32)
    k = rng.normal(0, 0.1, size=(3, 3, c, co)).astype(np.float32)
    fold = tuple(a.astype(np.float32) for a in (rng.normal(0, 0.5, c),
                                                rng.uniform(0.5, 1.5, c),
                                                rng.normal(0, 0.5, c)))
    return x, g, k, fold


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tol, name=""):
    want = _np(want)
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("has_fold", [False, True], ids=["nofold", "fold"])
def test_reference_wgrad_matches_pallas_wgrad(has_fold, dtype, tol):
    x, g, _, fold = _case(1 + has_fold)
    want = pfc._wgrad_impl(_j(x, dtype), _j(g, dtype),
                           tuple(_j(f) for f in fold) if has_fold else None)
    got = port.conv_bn_wgrad(_t(x, dtype), _t(g, dtype), tuple(_t(f) for f in fold), has_fold)
    assert got.shape == (9 * 128, 128) and got.dtype == torch.float32  # stays f32
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("has_fold", [False, True], ids=["nofold", "fold"])
def test_reference_dgrad_matches_pallas_dgrad(has_fold, dtype, tol):
    x, g, k, fold = _case(3 + has_fold, c=256)  # C != Co: the flip's transpose matters
    kflip = np.transpose(k[::-1, ::-1], (0, 1, 3, 2)).reshape(9 * 128, 256)
    want = pfc._dgrad_impl(_j(g, dtype), _j(kflip, dtype), _j(x, dtype),
                           tuple(_j(f) for f in fold) if has_fold else None)
    got = port.conv_bn_dgrad(_t(g, dtype), port.flip_kernel(_t(k, dtype)), _t(x, dtype),
                             tuple(_t(f) for f in fold), has_fold)
    assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
    np.testing.assert_array_equal(_np(port.flip_kernel(_t(k))), kflip)
    for name, g_, w_ in zip(("dx", "dbias", "dmul"), got, want):
        if not has_fold and name != "dx":
            assert not _np(g_).any(), f"{name} must be zero without a fold"
            continue
        _close(g_, w_, tol, name)


def _cotangents(seed, out_shape, co):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=out_shape).astype(np.float32),
            rng.normal(size=(co,)).astype(np.float32),
            rng.normal(0, 0.1, size=(co,)).astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("has_fold", [False, True], ids=["nofold", "fold"])
def test_conv_bn_fused_vjp_matches_jax(has_fold, dtype, tol):
    """The whole autograd.Function against jax.vjp(conv_bn_fused), cotangents
    on out, s1 and s2."""
    x, _, k, fold = _case(5 + has_fold)
    cot = _cotangents(6, x.shape[:3] + (128,), 128)
    jfold = tuple(_j(f) for f in fold)
    _, vjp = jax.vjp(lambda a, b, c: pfc.conv_bn_fused(a, b, c, has_fold),
                     _j(x, dtype), _j(k, dtype), jfold)
    want = vjp((_j(cot[0], dtype), _j(cot[1]), _j(cot[2])))

    tx, tk = _t(x, dtype).requires_grad_(), _t(k, dtype).requires_grad_()
    tfold = tuple(_t(f).requires_grad_() for f in fold)
    outs = port.conv_bn_fused(tx, tk, tfold, has_fold)
    got = torch.autograd.grad(outs, (tx, tk) + tfold,
                              (_t(cot[0], dtype), _t(cot[1]), _t(cot[2])), allow_unused=True)
    assert got[0].dtype == tx.dtype and got[1].dtype == tk.dtype and got[1].shape == tk.shape
    _close(got[0], want[0], tol, "dx")
    _close(got[1], want[1], tol, "dk")
    for name, g_, w_ in zip(("dmean", "dmul", "dbias"), got[2:], want[2]):
        if not has_fold:
            assert g_ is None or not _np(g_).any(), f"{name} must be zero without a fold"
            assert not _np(w_).any()
        else:
            _close(g_, w_, tol, name)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_head_conv_fused_vjp_matches_jax(dtype, tol):
    x, _, _, fold = _case(9)
    rng = np.random.default_rng(10)
    kmat = rng.normal(0, 0.1, size=(128, 8)).astype(np.float32)
    hbias = rng.normal(0, 0.5, size=(8,)).astype(np.float32)
    cot = rng.normal(size=x.shape[:3] + (8,)).astype(np.float32)
    _, vjp = jax.vjp(pfc.head_conv_fused, _j(x, dtype), _j(kmat, dtype), _j(hbias),
                     tuple(_j(f) for f in fold))
    want = vjp(_j(cot, dtype))

    leaves = (_t(x, dtype), _t(kmat, dtype), _t(hbias)) + tuple(_t(f) for f in fold)
    leaves = tuple(v.requires_grad_() for v in leaves)
    out = port.head_conv_fused(leaves[0], leaves[1], leaves[2], leaves[3:])
    got = torch.autograd.grad(out, leaves, _t(cot, dtype))
    names = ("dx", "dkmat", "dhbias", "dmean", "dmul", "dbias")
    for name, g_, w_ in zip(names, got, (want[0], want[1], want[2], *want[3])):
        _close(g_, w_, tol, name)
    assert got[1].dtype == leaves[1].dtype and got[2].dtype == torch.float32


def test_cpu_tensors_launch_no_backward_kernel():
    x, g, k, fold = _case(11, b=1)
    before = (port.conv_bn_wgrad.launches, port.conv_bn_dgrad.launches)
    tf = tuple(_t(f) for f in fold)
    port.conv_bn_wgrad(_t(x), _t(g), tf, True)
    port.conv_bn_dgrad(_t(g), port.flip_kernel(_t(k)), _t(x), tf, True)
    assert (port.conv_bn_wgrad.launches, port.conv_bn_dgrad.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pixel", [(0, 0), (8, 6), (3, 2)], ids=["corner", "far-corner", "inside"])
def test_one_pixel_cotangent_returns_the_activated_neighbourhood(pixel, dtype):
    """The premise of the on-card check of the prologue inside K4: with a
    cotangent that is 1 at one pixel and zero elsewhere, the plain version's
    dW IS the activated 3x3 neighbourhood of that pixel, bit for bit and zero
    in the SAME halo, the same for every output channel."""
    rng = np.random.default_rng(41)
    c, co, (y0, x0) = 32, 64, pixel
    x = rng.normal(size=(2, 9, 7, c)) * np.exp2(rng.integers(-6, 6, size=(2, 9, 7, c)))
    x = _t(x.astype(np.float32), dtype)
    fold = tuple(_t(f) for f in _case(42, c=c)[3])
    g = torch.zeros((2, 9, 7, co), dtype=x.dtype)
    g[1, y0, x0] = 1
    dw = port.conv_bn_wgrad(x, g, fold, True).reshape(3, 3, c, co)
    a = torch.nn.functional.pad(port.prologue(x, fold)[1].float(), (0, 0, 1, 1, 1, 1))
    assert dw.dtype == torch.float32
    assert torch.equal(dw, a[y0:y0 + 3, x0:x0 + 3, :, None].expand(3, 3, c, co))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_flipped_kernel_gives_the_gated_cotangent(dtype):
    """The premise of the on-card check of K5's epilogue: with a flipped
    kernel that is the identity at its centre tap, the plain version's da IS
    g (each sum is one product by 1 among zeros), so dx is the prologue's
    gradient applied to g elementwise, bit for bit, and the fold sums are the
    plain sums of that gradient."""
    rng = np.random.default_rng(43)
    c = 64
    x = rng.normal(size=(2, 9, 7, c)) * np.exp2(rng.integers(-6, 6, size=(2, 9, 7, c)))
    g = rng.normal(size=(2, 9, 7, c)) * np.exp2(rng.integers(-6, 6, size=(2, 9, 7, c)))
    x, g = _t(x.astype(np.float32), dtype), _t(g.astype(np.float32), dtype)
    mean, mul, bias = (_t(f) for f in _case(44, c=c)[3])
    kf = torch.zeros((9 * c, c), dtype=x.dtype)
    kf[4 * c + torch.arange(c), torch.arange(c)] = 1
    dx, dbias, dmul = port.conv_bn_dgrad(g, kf, x, (mean, mul, bias), True)
    dt = x.dtype
    xm = x - mean.to(dt)
    y = (xm * mul.to(dt) + bias.to(dt)).float()
    dy = g.float() * torch.where(y >= 0, torch.tensor(1.0), torch.tensor(0.01))
    assert torch.equal(dx, (dy * mul).to(dt))
    np.testing.assert_allclose(_np(dbias), _np(dy.sum(dim=(0, 1, 2))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(dmul), _np((dy * xm.float()).sum(dim=(0, 1, 2))),
                               rtol=1e-5, atol=1e-5)
