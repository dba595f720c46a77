"""Port relayout copy (K1) on the CPU: bit-equal to the JAX Pallas identity
kernel in interpret mode, for contiguous and permuted inputs; its gradient
is the same copy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_relayout_views import (RELAYOUT_DTYPES, RELAYOUT_KINDS, RELAYOUT_SIZES,
                                  relayout_views)
from xview2_tpu.ops.layout import _pallas_identity
from xview2_tpu_torch.ops import layout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 32, 32, 2), (3, 33, 17, 4), (2, 16, 16)])
def test_matches_pallas_identity(shape, dtype):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32) * 10
    want = np.asarray(_pallas_identity(jnp.asarray(x).astype(dtype), interpret=True),
                      np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layout.relayout_standard(t)
    assert got.is_contiguous() and got.dtype == t.dtype and got.data_ptr() != t.data_ptr()
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_permuted_input(dtype):
    """A channels-first buffer viewed as NHWC comes out contiguous NHWC."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 8, 5)).astype(np.float32))
    x = x.to(dtype).permute(0, 2, 3, 1)
    assert not x.is_contiguous()
    got = layout.relayout_standard(x)
    assert got.is_contiguous() and got.shape == x.shape
    assert torch.equal(got, x)


def test_gradient_is_the_same_copy():
    x = torch.arange(24.0).reshape(2, 3, 4).requires_grad_()
    (layout.relayout_standard(x) ** 2).sum().backward()
    assert torch.equal(x.grad, 2 * x.detach())


def test_cpu_tensor_does_not_launch():
    before = layout.relayout_cuda.launches
    layout.relayout_standard(torch.ones(2, 2))
    assert layout.relayout_cuda.launches == before
    with pytest.raises(ValueError):
        layout.relayout_cuda(torch.ones(2, 2))


@pytest.mark.parametrize("kind", RELAYOUT_KINDS)
@pytest.mark.parametrize("n", RELAYOUT_SIZES)
@pytest.mark.parametrize("dtype", RELAYOUT_DTYPES)
def test_path_choice(dtype, n, kind):
    """The wrapper's path choice, a pure function of the layout: the path
    each view takes, and merged dims and strides that address exactly the
    view's elements."""
    view, path = relayout_views(dtype, n, "cpu")[kind]
    got, dims, strides = layout.relayout_plan(view.shape, view.stride())
    assert got == path
    assert (path == layout.FLAT) == view.is_contiguous()
    if path == layout.FLAT:
        assert (dims, strides) == ((), ())
        return
    assert len(dims) == len(strides) == 4
    again = torch.as_strided(view, dims, strides, view.storage_offset())
    assert torch.equal(again.reshape(view.shape), view)


def test_path_choice_of_the_paths_tensors():
    """Every call on the main paths is handed a contiguous tensor (flat);
    the smoke's NCHW buffer viewed NHWC is strided, merged to three dims."""
    for t in (torch.zeros((4, 64, 64, 2)), torch.zeros((16, 8, 32), dtype=torch.int32),
              torch.zeros((16, 8, 32, 2), dtype=torch.bfloat16)):
        assert layout.relayout_plan(t.shape, t.stride())[0] == layout.FLAT
    p = torch.zeros((4, 2, 64, 64)).permute(0, 2, 3, 1)
    assert layout.relayout_plan(p.shape, p.stride()) == (
        layout.STRIDED, (1, 4, 4096, 2), (0, 8192, 1, 4096))
