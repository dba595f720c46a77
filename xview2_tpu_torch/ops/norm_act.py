"""The eval BatchNorm epilogue in one pass: the folded affine, an optional
residual add and the activation,

    out = act(((x - mean) * mul) + bias)                 (no residual)
    out = relu((((x - mean) * mul) + bias) + residual)   (the bottleneck's tail)

on an NHWC map ``x`` of bfloat16 or float32, with the float32 fold vectors
``(mean, mul, bias)`` of ``BatchNorm.fold`` (one entry per channel, the last
axis) and act ``"relu"``, ``"leaky"`` or ``"none"``; a residual comes only
with ``"relu"``.  Each op rounds to x's dtype, the vectors are cast to it
first, and the activations are PyTorch's: this is the chain that the models
ran eagerly (JAX ``_norm_act``, then ``relu(out + identity)``), and the
kernel is bit-equal to it.

:func:`norm_act` is the one dispatch of the models' call sites.  Where
autograd records nothing (the eval step runs under ``torch.inference_mode``)
a CUDA map of bfloat16 or float32 goes to the kernel (``csrc/norm_act.cu``),
which launches or raises (:func:`takes` says beforehand what it takes).  The
plain version (:func:`norm_act_reference`, that eager chain) runs on a CPU
map, under autograd (whose backward is then autograd's) and in float64, the
precision of the parity runs, which the kernel does not compute in.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from xview2_tpu_torch.ops import cuda_build
from xview2_tpu_torch.ops.packed_fused_conv import leaky_slope

ACTS = {"none": 0, "relu": 1, "leaky": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_VECTORS = 1024  # vectors of channels a row: a block of the kernel holds whole rows
_SLOPE = {dt: leaky_slope(dt) for dt in _DTYPE_CODE}


def activate(y: torch.Tensor, act: str) -> torch.Tensor:
    """The activation of the stock call sites, in y's dtype."""
    if act == "leaky":
        return F.leaky_relu(y, leaky_slope(y.dtype))
    if act == "relu":
        return F.relu(y)
    return y


def norm_act_reference(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                       bias: torch.Tensor, act: str,
                       residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the folded affine in x's dtype, each op rounding, the
    residual added, then the activation."""
    dt = x.dtype
    y = (x - mean.to(dt)) * mul.to(dt) + bias.to(dt)
    if residual is not None:
        y = y + residual
    return activate(y, act)


def records(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def channel_stride(x: torch.Tensor) -> Optional[int]:
    """The stride in elements of x's channel axis (the last), where x's
    elements fill one span of memory without gaps or overlaps, its axes in
    any order; None otherwise.  1: rows of C channels (a contiguous NHWC
    map); more: runs of that many elements share a channel (an NCHW map
    seen as NHWC)."""
    expect = 1
    for stride, size in sorted((s, n) for n, s in zip(x.shape, x.stride()) if n > 1):
        if stride != expect:
            return None
        expect *= size
    return x.stride(-1) if x.shape[-1] > 1 else 1


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    return all(sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape) if n > 1)


def _vector_width(x: torch.Tensor, residual: Optional[torch.Tensor]) -> int:
    """Channels in one 16-byte vector of the kernel on a contiguous NHWC
    map, 1 where C is no multiple of it or a map is not 16-byte aligned
    (the scalar form)."""
    width = 16 // x.element_size()
    aligned = x.data_ptr() % 16 == 0 and (residual is None or residual.data_ptr() % 16 == 0)
    return width if x.shape[-1] % width == 0 and aligned else 1


def takes(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
          residual: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernel takes these operands, wherever they lie: x of
    bfloat16 or float32 whose elements fill one span of memory (any order
    of the axes: the output keeps x's layout, as the eager chain does),
    float32 vectors of C entries, a residual of x's shape, dtype and layout,
    and, with the channels innermost, at most ``MAX_VECTORS`` vectors of
    channels a row."""
    if x.dtype not in _DTYPE_CODE or x.dim() == 0 or x.shape[-1] == 0:
        return False
    inner = channel_stride(x)
    c = x.shape[-1]
    if inner is None or any(v.dtype != torch.float32 or v.shape != (c,)
                            for v in (mean, mul, bias)):
        return False
    if residual is not None and (residual.dtype != x.dtype or residual.shape != x.shape
                                 or not _same_layout(x, residual)):
        return False
    return inner > 1 or c // _vector_width(x, residual) <= MAX_VECTORS


# Replaces no TPU kernel: XLA fuses the affine, the residual add and the
# activation into the producer there, while eager PyTorch makes a pass over
# the map for each (and for each cast of a fold vector).  Bound on the card:
# bytes, one read of x (and of the residual) and one write.  The wrapper does
# only what each call must (as K1's and K6's): one cached entry point, scalar
# arguments, ``empty_like``.
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGS = (_PTR,) * 6 + (ctypes.c_longlong, _INT, ctypes.c_longlong, _INT, _INT, ctypes.c_float,
                       _PTR)


def _check_act(act: str, residual: Optional[torch.Tensor]) -> None:
    if act not in ACTS:
        raise ValueError(f"norm_act: act must be one of {sorted(ACTS)}, got {act!r}")
    if residual is not None and act != "relu":
        raise ValueError(f"norm_act: a residual comes only with relu (the bottleneck's tail), "
                         f"got {act!r}")


def norm_act_cuda(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                  act: str, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on CUDA tensors."""
    index = x.get_device()  # -1 on the CPU
    ops = (mean, mul, bias) + (() if residual is None else (residual,))
    if index < 0 or any(t.get_device() != index for t in ops):
        raise ValueError("norm_act_cuda needs x, the fold vectors and the residual on one "
                         "CUDA device")
    _check_act(act, residual)
    if not takes(x, mean, mul, bias, residual):
        res = None if residual is None else (tuple(residual.shape), residual.dtype,
                                             residual.stride())
        raise ValueError(
            f"norm_act_cuda takes an x of bfloat16 or float32 whose elements fill one span "
            f"of memory (with the channels innermost, at most {MAX_VECTORS} vectors of channels "
            f"a row), float32 vectors of x.shape[-1] entries and a residual of x's shape, dtype "
            f"and layout; got x {tuple(x.shape)} {x.dtype} (strides {x.stride()}), vectors "
            f"{[(tuple(v.shape), v.dtype) for v in (mean, mul, bias)]}, residual {res}")
    c = x.shape[-1]
    vecs = [v if v.is_contiguous() else v.contiguous() for v in (mean, mul, bias)]
    out = torch.empty_like(x)  # x's layout: its elements fill one span
    err = cuda_build.function("norm_act", "norm_act", _ARGS)(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        *(v.data_ptr() for v in vecs), out.data_ptr(), x.numel() // c, c, channel_stride(x),
        _DTYPE_CODE[x.dtype], ACTS[act], _SLOPE[x.dtype],
        torch.cuda.current_stream(index).cuda_stream)
    norm_act_cuda.launches += 1
    if err:
        cuda_build.check(err, "norm_act")
    return out


norm_act_cuda.launches = 0


def norm_act(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
             act: str, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(((x - mean) * mul) + bias [+ residual])`` in x's dtype: the
    kernel on a CUDA map where autograd records nothing, else the plain
    version (a CPU map, autograd, float64)."""
    _check_act(act, residual)
    if x.is_cuda and x.dtype != torch.float64 and not records(x, mean, mul, bias, residual):
        return norm_act_cuda(x, mean, mul, bias, act, residual)
    return norm_act_reference(x, mean, mul, bias, act, residual)
