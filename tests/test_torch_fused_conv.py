"""Port fused conv+BN (K2) and fused head (K3) on the CPU (their plain
versions) against the JAX Pallas kernels in interpret mode.

Tolerances: float32 at the JAX kernel test's own rtol 1e-5 / atol 1e-4
(sums in another order); bfloat16 output at atol 1e-2 (XLA may keep excess
precision between the prologue's bf16 ops, PyTorch rounds after each) and
the f32 sums at rtol 1e-3."""

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


def _case(seed, b=2, h=16, w=16, c=128, co=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    # kernel scale keeps the outputs at the C=128 magnitude for every C
    k = rng.normal(0, 0.1 * np.sqrt(128 / c), size=(3, 3, c, co)).astype(np.float32)
    fold = tuple(a.astype(np.float32) for a in (rng.normal(0, 0.5, c),
                                                rng.uniform(0.5, 1.5, c),
                                                rng.normal(0, 0.5, c)))
    return x, k, fold


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_fold", [False, True], ids=["nofold", "fold"])
@pytest.mark.parametrize("c", [128, 384])
def test_conv_bn_fused_matches_jax(c, has_fold, dtype):
    x, k, fold = _case(c + has_fold, c=c)
    want = pfc.conv_bn_fused(_jax(x, dtype), _jax(k, dtype),
                             tuple(jnp.asarray(f) for f in fold), has_fold)
    got = port.conv_bn_fused(_torch(x, dtype), _torch(k, dtype),
                             tuple(torch.from_numpy(f) for f in fold), has_fold)
    assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
    if dtype == "float32":
        for name, w_, g in zip(("out", "s1", "s2"), want, got):
            np.testing.assert_allclose(_np(g), _np(w_), rtol=1e-5, atol=1e-4, err_msg=name)
    else:
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=0, atol=1e-2)
        for name, w_, g in zip(("s1", "s2"), want[1:], got[1:]):
            scale = np.abs(_np(w_)).max()
            np.testing.assert_allclose(_np(g), _np(w_), rtol=1e-3, atol=1e-3 * scale,
                                       err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_conv_fused_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x, _, fold = _case(7, c=128)
    kmat = rng.normal(0, 0.1, size=(128, 8)).astype(np.float32)
    hbias = rng.normal(0, 0.5, size=(8,)).astype(np.float32)
    want = pfc.head_conv_fused(_jax(x, dtype), jnp.asarray(kmat), jnp.asarray(hbias),
                               tuple(jnp.asarray(f) for f in fold))
    got = port.head_conv_fused(_torch(x, dtype), torch.from_numpy(kmat),
                               torch.from_numpy(hbias), tuple(torch.from_numpy(f) for f in fold))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 16, 16, 8)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-2)


def test_plain_versions_match_jax_oracles():
    """reference_conv_bn / reference_head against the JAX pure-XLA oracles."""
    x, k, fold = _case(11)
    jf = tuple(jnp.asarray(f) for f in fold)
    tf = tuple(torch.from_numpy(f) for f in fold)
    want = pfc.reference_conv_bn(jnp.asarray(x), jnp.asarray(k), jf)
    got = port.reference_conv_bn(torch.from_numpy(x), torch.from_numpy(k), tf)
    for w_, g in zip(want, got):
        np.testing.assert_allclose(_np(g), _np(w_), rtol=1e-5, atol=1e-4)
    kmat = np.random.default_rng(3).normal(0, 0.1, size=(128, 4)).astype(np.float32)
    hb = np.arange(4, dtype=np.float32)
    np.testing.assert_allclose(
        _np(port.reference_head(torch.from_numpy(x), torch.from_numpy(kmat),
                                torch.from_numpy(hb), tf)),
        _np(pfc.reference_head(jnp.asarray(x), jnp.asarray(kmat), jnp.asarray(hb), jf)),
        rtol=1e-5, atol=1e-4)


def test_supported_is_the_jax_rule():
    shapes = [((16, 128, 128, 768), 256), ((16, 64, 64, 1536), 512), ((2, 8, 8, 128), 128),
              ((16, 512, 512, 128), 128), ((2, 16, 16, 64), 64), ((4, 256, 256, 384), 128)]
    for shape, co in shapes:
        for it in (2, 4):
            assert port.supported(shape, co, it) == pfc.supported(shape, co, it), (shape, co, it)


def test_cpu_tensors_do_not_launch():
    x, k, fold = _case(13, b=1)
    tf = tuple(torch.from_numpy(f) for f in fold)
    before = (port.conv_bn_fused.launches, port.head_conv_fused.launches)
    port.conv_bn_fused(torch.from_numpy(x), torch.from_numpy(k), tf, True)
    port.head_conv_fused(torch.from_numpy(x), torch.zeros(128, 8), torch.zeros(8), tf)
    assert (port.conv_bn_fused.launches, port.head_conv_fused.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_centre_tap_returns_the_activated_map(dtype):
    """The premise of the on-card check of the prologue inside K2: with a
    kernel that is the identity at its centre tap and zero elsewhere, the
    plain version's out IS the activated map, bit for bit (a * 1 and zeros
    summed in f32, one exact rounding), and the SAME halo adds nothing."""
    rng = np.random.default_rng(31)
    c = 32
    x = rng.normal(size=(2, 9, 7, c)) * np.exp2(rng.integers(-6, 6, size=(2, 9, 7, c)))
    x = _torch(x.astype(np.float32), dtype)
    fold = tuple(torch.from_numpy(f) for f in _case(32, c=c)[2])
    k = torch.zeros((3, 3, c, c), dtype=x.dtype)
    k[1, 1, torch.arange(c), torch.arange(c)] = 1
    out, s1, _ = port.conv_bn_fused(x, k, fold, True)
    a = port.prologue(x, fold)
    assert torch.equal(out, a)
    np.testing.assert_allclose(_np(s1), _np(a.float().sum(dim=(0, 1, 2))), rtol=1e-5, atol=1e-4)


def test_kernel_variant_names_cover_both_dispatches():
    """Every code the four C entry points' variant queries can return has a
    name: 0 and 1 for the earlier kernels, the four tile widths of the
    pipelined forward and input gradient (which share one main loop), 2 for
    the pipelined weight gradient, 1 and 2 for the head's mma.sync kernel
    with its 4-stage and (at C = 256) 3-stage ring."""
    assert set(port._VARIANTS) == {"conv_bn_fused", "conv_bn_wgrad", "conv_bn_dgrad",
                                   "head_conv_fused"}
    assert {v[0] for v in port._VARIANTS.values()} == {"fused_conv", "fused_conv_bwd",
                                                       "fused_head"}
    assert set(port._VARIANTS["conv_bn_wgrad"][1]) == {0, 1, 2}
    assert set(port._VARIANTS["head_conv_fused"][1]) == {0, 1, 2}
    assert "mma.sync" in port._VARIANTS["head_conv_fused"][1][1]
    assert "mma.sync" in port._VARIANTS["head_conv_fused"][1][2]
    assert "3-stage" in port._VARIANTS["head_conv_fused"][1][2]
    for kernel in ("conv_bn_fused", "conv_bn_dgrad"):
        names = port._VARIANTS[kernel][1]
        assert set(names) == {0, 1, 16, 32, 64, 128}
        assert names[0] == "f32 FMA" and "wmma row tile" in names[1]
        for tw in (16, 32, 64, 128):
            assert f"wgmma pipelined, tile {256 // tw}x{tw} px" in names[tw]
