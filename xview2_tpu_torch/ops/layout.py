"""Relayout copy at the model/loss seam (port of ``xview2_tpu/ops/layout.py``).

The JAX package copies the eval logits (and the train labels) into a
standard row-major buffer with an identity Pallas kernel, because XLA:TPU
otherwise propagates a batch-minor layout into the loss.  The port keeps the
copy at the same place (``parallel/steps.py``) as a hand-written CUDA kernel
(``csrc/relayout.cu``): a strided tensor of rank <= 4 in, a new contiguous
tensor out, bit-exact.  Its gradient is the same copy of the cotangent.

On a CPU tensor the plain version, ``x.contiguous().clone()``, runs instead;
a CUDA tensor always goes to the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from xview2_tpu_torch.ops import cuda_build


def relayout_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a new contiguous copy."""
    return x.contiguous().clone()


def relayout_cuda(x: torch.Tensor) -> torch.Tensor:
    """The relayout kernel on a CUDA tensor of rank <= 4 (any strides)."""
    if not x.is_cuda:
        raise ValueError("relayout_cuda needs a CUDA tensor")
    if x.dim() > 4:
        raise ValueError(f"relayout_cuda takes rank <= 4, got shape {tuple(x.shape)}")
    if x.element_size() not in (1, 2, 4, 8):
        raise ValueError(f"relayout_cuda: unsupported element size {x.element_size()}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    pad = 4 - x.dim()
    dims = (ctypes.c_longlong * 4)(*([1] * pad + list(x.shape)))
    strides = (ctypes.c_longlong * 4)(*([0] * pad + list(x.stride())))
    fn = cuda_build.function("relayout", "relayout_copy", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p))
    err = fn(x.data_ptr(), out.data_ptr(), x.element_size(), dims, strides,
             torch.cuda.current_stream(x.device).cuda_stream)
    relayout_cuda.launches += 1
    cuda_build.check(err, "relayout")
    return out


relayout_cuda.launches = 0


def _identity(x: torch.Tensor) -> torch.Tensor:
    return relayout_cuda(x) if x.is_cuda else relayout_reference(x)


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _identity(x)

    @staticmethod
    def backward(ctx, g):
        # relayout the cotangent too, as the JAX custom_vjp does
        return _identity(g)


def relayout_standard(x: torch.Tensor) -> torch.Tensor:
    """Copy ``x`` into a new contiguous (standard-layout) buffer."""
    return _Relayout.apply(x)
