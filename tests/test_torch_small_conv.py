"""The port's small-channel 3x3 conv (``ops/small_conv.py``) against the JAX
module ``ops/pallas_conv.py`` with its Pallas kernels in interpret mode, at
the shapes and tolerances of ``tests/test_pallas_conv.py``: forward rtol =
atol = 2e-4, gradients rtol = atol = 2e-3 (float32 sums in another order).
On the CPU the port runs the kernels' plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xview2_tpu.ops.pallas_conv as pc
from xview2_tpu_torch.ops import small_conv as sc


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pc, "INTERPRET", True)


def _case(seed, shape, co, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(dtype)
    k = (rng.normal(size=(3, 3, shape[-1], co)) * 0.1).astype(dtype)
    return x, k


def test_forward_matches_jax():
    x, k = _case(0, (2, 16, 128, 32), 16)
    want = np.asarray(pc.conv3x3_small(jnp.asarray(x), jnp.asarray(k)))
    got = sc.conv3x3_small(torch.from_numpy(x), torch.from_numpy(k))
    assert got.shape == (2, 16, 128, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_gradients_match_jax():
    x, k = _case(1, (1, 16, 128, 8), 8)
    gx, gk = jax.grad(lambda x, k: jnp.sum(pc.conv3x3_small(x, k) ** 2), (0, 1))(
        jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    (sc.conv3x3_small(xt, kt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("c,co", [(32, 16), (8, 8), (24, 40)])
def test_plain_kernel_versions_match_the_jax_impls(c, co):
    """K7's and K8's plain versions against ``_conv3x3_fwd_impl`` and
    ``_conv3x3_wgrad_impl`` directly, with the dx use of K7 (the cotangent
    with the flipped, IO-transposed kernel)."""
    rng = np.random.default_rng(c + co)
    x = rng.normal(size=(2, 16, 128, c)).astype(np.float32)
    g = rng.normal(size=(2, 16, 128, co)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, co)) * 0.1).astype(np.float32)
    kmat = sc.kernel_to_mat(torch.from_numpy(k))
    np.testing.assert_array_equal(kmat.numpy(), np.asarray(pc.kernel_to_mat(jnp.asarray(k))))
    assert torch.equal(sc.mat_to_kernel(kmat, c), torch.from_numpy(k))
    want = np.asarray(pc._conv3x3_fwd_impl(jnp.asarray(x), jnp.asarray(kmat.numpy())))
    np.testing.assert_allclose(sc.reference_conv3x3(torch.from_numpy(x), kmat).numpy(), want,
                               rtol=2e-4, atol=2e-4)
    k_flip = jnp.transpose(jnp.asarray(k)[::-1, ::-1], (0, 1, 3, 2))
    want_dx = np.asarray(pc._conv3x3_fwd_impl(jnp.asarray(g), pc.kernel_to_mat(k_flip)))
    kf = sc.kernel_to_mat(torch.from_numpy(k).flip(0, 1).permute(0, 1, 3, 2))
    np.testing.assert_allclose(sc.reference_conv3x3(torch.from_numpy(g), kf).numpy(), want_dx,
                               rtol=2e-4, atol=2e-4)
    want_dw = np.asarray(pc._conv3x3_wgrad_impl(jnp.asarray(x), jnp.asarray(g)))
    got_dw = sc.reference_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    assert got_dw.shape == (9 * c, co) and got_dw.dtype == torch.float32
    np.testing.assert_allclose(got_dw.numpy(), want_dw, rtol=2e-3, atol=2e-3)


def test_bfloat16_forward_and_gradients_match_jax():
    """The docstring's dtype at a small size: bf16 in, f32 accumulation, bf16
    out.  One bf16 rounding of the output (2^-8 relative) plus 1e-2 of the
    scale for the sums' order; dW is cast to the kernel's bf16."""
    x, k = _case(2, (1, 16, 128, 32), 32)
    xb, kb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    want = pc.conv3x3_small(xb, kb)
    gx, gk = jax.grad(lambda x, k: jnp.sum(pc.conv3x3_small(x, k).astype(jnp.float32) ** 2),
                      (0, 1))(xb, kb)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    kt = torch.from_numpy(k).to(torch.bfloat16).requires_grad_()
    out = sc.conv3x3_small(xt, kt)
    assert out.dtype == torch.bfloat16
    (out.float() ** 2).sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and kt.grad.dtype == torch.bfloat16

    def close(got, want):
        want = np.asarray(want.astype(jnp.float32))
        got = got.detach().float().numpy()
        tol = 2 ** -7 * np.abs(want) + 1e-2 * np.abs(want).max()
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()

    close(out, want)
    close(xt.grad, gx)
    close(kt.grad, gk)


def test_supported_predicate():
    cases = [((16, 512, 512, 32), 32), ((16, 256, 256, 64), 64), ((16, 512, 512, 96), 32),
             ((16, 512, 500, 32), 32), ((16, 8, 128, 32), 32), ((16, 512, 512, 12), 32),
             ((512, 512, 32), 32)]
    for shape, co in cases:
        assert sc.supported(shape, co) == pc.supported(shape, co), (shape, co)
    assert sc.supported((16, 512, 512, 32), 32) and not sc.supported((16, 512, 512, 96), 32)


def test_wrappers_raise_off_the_card_and_on_bad_shapes():
    x = torch.zeros((1, 16, 16, 8))
    with pytest.raises(ValueError):
        sc.small_conv_fwd(x, torch.zeros((72, 8)))          # a CPU tensor
    with pytest.raises(ValueError):
        sc.small_conv_wgrad(x, torch.zeros((1, 16, 16, 8)))  # a CPU tensor
    with pytest.raises(ValueError):
        sc.conv3x3_small(x, torch.zeros((3, 3, 16, 8)))      # channel mismatch
    assert sc.small_conv_fwd.launches == 0 and sc.small_conv_wgrad.launches == 0
