"""The port's plain ``row_shift`` against the JAX row-shift kernel in Pallas
interpret mode and against ``_row_shift_pass`` (both of its branches).

Tolerances.  The nearest tap (``sel = 0``), the mask channel and the zero
fill involve no arithmetic on the values: EQUAL.  The lerp ``lo*(1-f) +
hi*f`` is two multiplies and an add in float32 in the port (and in the CUDA
kernel, which forbids the FMA contraction); XLA on the CPU contracts it into
an FMA, so with arbitrary fractions JAX's own CPU result is one float32 ulp
off (1.5e-5 at values near 255; the JAX package's own test allows 1e-4 for
the same reason).  Where the products are exact in float32 (integer grey
levels, fractions that are multiples of 1/8) the contraction changes nothing
and the lerp is held EQUAL too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xview2_tpu.ops import autoaugment as jaa
from xview2_tpu.ops.rowshift import row_shift_pallas
from xview2_tpu_torch.ops import rowshift as trs


def _pallas(packed, shift, sel):
    """``row_shift_pallas`` in interpret mode on one (H, W, C) map, laid out
    and padded as ``_row_shift_pass`` does."""
    h, w, c = packed.shape
    pad = w // 2
    x = jnp.pad(jnp.swapaxes(jnp.asarray(packed), 1, 2), ((0, 0), (0, 0), (pad, pad)))
    out = row_shift_pallas(x, jnp.asarray(shift), jnp.full((1,), sel, jnp.int32), w, pad,
                           interpret=True)
    return np.asarray(jnp.swapaxes(out, 1, 2))


def _port(packed, shift, sel, axis=2):
    out = trs.row_shift(torch.from_numpy(packed)[None], torch.from_numpy(shift)[None],
                        torch.tensor([sel]), axis=axis)
    return out[0].numpy()


def _case(seed, h, w, c, dyadic):
    rng = np.random.default_rng(seed)
    bound = w // 2 - 1  # the Pallas kernel's no-wrap precondition
    if dyadic:
        packed = rng.integers(0, 256, (h, w, c)).astype(np.float32)
        shift = (rng.integers(-8 * bound, 8 * bound + 1, (h,)) / 8.0).astype(np.float32)
    else:
        packed = (rng.normal(size=(h, w, c)) * 50 + 100).astype(np.float32)
        shift = rng.uniform(-bound, bound, (h,)).astype(np.float32)
    return packed, shift


@pytest.mark.parametrize("sel", [0, 1])
@pytest.mark.parametrize("c", [4, 7])
@pytest.mark.parametrize("h", [32, 38])
@pytest.mark.parametrize("w", [32, 54])
def test_plain_row_shift_equals_pallas_kernel(sel, c, h, w):
    """Integer grey levels and fractions in eighths: every product is exact,
    so the lerp, the nearest tap, the mask channel and the fill are EQUAL."""
    packed, shift = _case(sel * 10 + c + h + w, h, w, c, dyadic=True)
    assert np.any(shift != np.floor(shift)) and np.any(np.abs(shift) > w // 4)
    np.testing.assert_array_equal(_port(packed, shift, sel), _pallas(packed, shift, sel))


@pytest.mark.parametrize("sel", [0, 1])
@pytest.mark.parametrize("c", [4, 7])
def test_plain_row_shift_on_arbitrary_values(sel, c):
    """Arbitrary values and fractions (the inputs of the JAX package's own
    kernel test): nearest taps and the mask channel EQUAL, the lerp within
    1e-4 (one ulp: XLA's CPU FMA contraction)."""
    packed, shift = _case(sel + c, 38, 54, c, dyadic=False)
    got, want = _port(packed, shift, sel), _pallas(packed, shift, sel)
    np.testing.assert_array_equal(got[..., -1], want[..., -1])
    if sel == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert np.abs(got - want).max() <= 2 ** -15  # an ulp of a value below 256


@pytest.mark.parametrize("sel", [False, True])
@pytest.mark.parametrize("force_pallas", [False, True])
def test_plain_row_shift_equals_row_shift_pass(sel, force_pallas, monkeypatch):
    """``_row_shift_pass`` through its Pallas branch and through its XLA
    gather branch, with shifts PAST the edge (up to 1.5 widths, which only
    the gather branch takes): EQUAL on exact products."""
    monkeypatch.setattr(jaa, "force_pallas_interpret", force_pallas)
    h, w, c = 19, 40, 4
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 256, (h, w, c)).astype(np.float32)
    reach = (w // 2 - 1) if force_pallas else int(1.5 * w)
    shift = (rng.integers(-8 * reach, 8 * reach + 1, (h,)) / 8.0).astype(np.float32)
    want = np.asarray(jaa._row_shift_pass(jnp.asarray(packed), jnp.asarray(shift),
                                          jnp.bool_(sel), float(reach)))
    got = _port(packed, shift, int(sel))
    np.testing.assert_array_equal(got, want)
    if not force_pallas:
        assert (got[np.abs(shift) >= w] == 0).all() and np.any(np.abs(shift) >= w)


@pytest.mark.parametrize("sel", [0, 1])
def test_axis_1_is_the_transposed_pass_and_batches_are_independent(sel):
    """The vertical pass (one shift per column) equals the JAX form, which
    transposes around the kernel; and a batch equals its samples one by one,
    each with its own ``sel``."""
    rng = np.random.default_rng(6)
    b, h, w, c = 3, 24, 38, 4
    x = rng.integers(0, 256, (b, h, w, c)).astype(np.float32)
    shift = (rng.integers(-8 * 11, 8 * 11 + 1, (b, w)) / 8.0).astype(np.float32)
    sels = torch.tensor([sel, 1 - sel, sel])
    got = trs.row_shift(torch.from_numpy(x), torch.from_numpy(shift), sels, axis=1).numpy()
    for i in range(b):
        want = np.swapaxes(_pallas(np.ascontiguousarray(np.swapaxes(x[i], 0, 1)), shift[i],
                                   int(sels[i])), 0, 1)
        np.testing.assert_array_equal(got[i], want)


def test_wrapper_checks_its_arguments():
    x = torch.zeros((2, 8, 8, 4))
    with pytest.raises(ValueError):
        trs.row_shift(x, torch.zeros((2, 9)), torch.zeros(2))
    with pytest.raises(ValueError):
        trs.row_shift(x.double(), torch.zeros((2, 8)), torch.zeros(2))
    with pytest.raises(ValueError):
        trs.row_shift(x, torch.zeros((2, 8)), torch.zeros(2), axis=3)
    with pytest.raises(ValueError):
        trs.row_shift_cuda(x, torch.zeros((2, 8)), torch.zeros(2))  # a CPU tensor
    assert trs.row_shift_cuda.launches == 0
