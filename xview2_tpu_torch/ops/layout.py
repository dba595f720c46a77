"""Relayout copy at the model/loss seam (port of ``xview2_tpu/ops/layout.py``).

The JAX package copies the eval logits (and the train labels) into a
standard row-major buffer with an identity Pallas kernel, because XLA:TPU
otherwise propagates a batch-minor layout into the loss.  The port keeps the
copy at the same place (``parallel/steps.py``) as a hand-written CUDA kernel
(``csrc/relayout.cu``): a contiguous tensor of any rank, or a strided one of
rank <= 4, in; a new contiguous tensor out, bit-exact.  The kernel takes one
of two paths, which :func:`relayout_plan` picks from the layout alone.  Its
gradient is the same copy of the cotangent.

On a CPU tensor the plain version, ``x.contiguous().clone()``, runs instead;
a CUDA tensor always goes to the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from xview2_tpu_torch.ops import cuda_build

# the kernel's paths (csrc/relayout.cu): (a) a contiguous source, (b) any
# other strides
FLAT, STRIDED = 0, 1

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FLAT_ARGS = (_PTR, _PTR, _LL, _PTR)
_STRIDED_ARGS = (_PTR, _PTR, _INT) + (_LL,) * 8 + (_PTR,)


def relayout_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a new contiguous copy."""
    return x.contiguous().clone()


def relayout_plan(shape: Sequence[int], strides: Sequence[int]
                  ) -> Tuple[int, Tuple[int, ...], Tuple[int, ...]]:
    """The kernel path that copies a view, as a pure function of its layout.

    Unit dims are dropped and dims that are contiguous with each other are
    merged; returns ``(path, dims, strides)``.  ``FLAT`` with no dims for a
    contiguous view; otherwise ``STRIDED`` with the merged dims and strides
    (in elements) padded in front to four."""
    merged = []
    for n, s in zip(shape, strides):
        if n == 1:
            continue
        if merged and merged[-1][1] == s * n:
            merged[-1] = (merged[-1][0] * n, s)
        else:
            merged.append((n, s))
    if not merged or (len(merged) == 1 and merged[0][1] == 1) or 0 in shape:
        return FLAT, (), ()
    pad = 4 - len(merged)
    return (STRIDED, (1,) * pad + tuple(n for n, _ in merged),
            (0,) * pad + tuple(s for _, s in merged))


def relayout_cuda(x: torch.Tensor) -> torch.Tensor:
    """The relayout kernel on a CUDA tensor: any strides at rank <= 4, any
    rank when contiguous.

    Every piece of host work per call is one the card's time at the train
    size (about 10 us a tensor) can hide: the bound entry point is cached,
    dims and strides go as scalars, the stream handle comes from
    ``current_stream(index)`` and the output from ``empty_like``, the
    cheapest public calls for them (PERF.md)."""
    if not x.is_cuda:
        raise ValueError("relayout_cuda needs a CUDA tensor")
    if x.is_contiguous():
        out = torch.empty_like(x)  # x is dense: its layout is the contiguous one
        nbytes = out.nbytes
        if nbytes == 0:
            return out
        err = cuda_build.function("relayout", "relayout_flat", _FLAT_ARGS)(
            x.data_ptr(), out.data_ptr(), nbytes,
            torch.cuda.current_stream(x.get_device()).cuda_stream)
    else:
        if x.dim() > 4:
            raise ValueError(f"relayout_cuda takes rank <= 4, got shape {tuple(x.shape)}")
        itemsize = x.element_size()
        if itemsize not in (1, 2, 4, 8):
            raise ValueError(f"relayout_cuda: unsupported element size {itemsize}")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        if out.numel() == 0:
            return out
        _, dims, strides = relayout_plan(x.shape, x.stride())
        err = cuda_build.function("relayout", "relayout_strided", _STRIDED_ARGS)(
            x.data_ptr(), out.data_ptr(), itemsize, *dims, *strides,
            torch.cuda.current_stream(x.get_device()).cuda_stream)
    relayout_cuda.launches += 1
    if err:
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
