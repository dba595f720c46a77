"""3x3 SAME stride-1 conv for small channel counts at high resolution: the
port's counterpart of ``xview2_tpu/ops/pallas_conv.py``.

``conv3x3_small(x, kernel)`` takes an NHWC map with ``C, Co <= 64`` (multiples
of 8) and an HWIO kernel, accumulates in float32 and returns the output in
x's dtype.  It is differentiable: ``dx`` is the same conv of the cotangent
with the spatially flipped, IO-transposed kernel, and ``dW`` is ``A^T @ dY``
summed over all pixels as a float32 ``(9C, Co)`` matrix (rows ``(dy, dx, c)``),
cast to the kernel's dtype.  Like its JAX counterpart it is a second entry
point beside the models, which do not call it.

On a CUDA tensor the forward and ``dx`` launch ``small_conv_fwd`` and ``dW``
launches ``small_conv_wgrad`` (``csrc/small_conv.cu``); the wrappers raise on
what the kernels do not take.  On a CPU tensor the plain versions
(:func:`reference_conv3x3`, :func:`reference_wgrad`) run.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from xview2_tpu_torch.ops import cuda_build
from xview2_tpu_torch.ops.packed_fused_conv import (conv3x3_nhwc, full_precision,
                                                    reference_wgrad as _im2col_wgrad)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def kernel_to_mat(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Co) HWIO -> (9C, Co), tap-major rows (dy, dx, c)."""
    kh, kw, c, co = kernel.shape
    return kernel.reshape(kh * kw * c, co)


def mat_to_kernel(kmat: torch.Tensor, c: int) -> torch.Tensor:
    return kmat.reshape(3, 3, c, kmat.shape[1])


def reference_conv3x3(x: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    """Plain version of ``small_conv_fwd``: x (B, H, W, C), kmat (9C, Co) in
    x's dtype; float32 accumulation (no TF32), output in x's dtype."""
    with full_precision():
        return conv3x3_nhwc(x, mat_to_kernel(kmat, x.shape[-1]).to(x.dtype)).to(x.dtype)


def reference_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of ``small_conv_wgrad``: ``A^T @ g`` as a float32 ``(9C,
    Co)`` matrix, A the im2col of x with a zero SAME halo."""
    return _im2col_wgrad(x, g, None)


def _check(what: str, x: torch.Tensor, co: int) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: x must be (B, H, W, C) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous NHWC and 16-byte aligned")
    c = x.shape[3]
    if c % 8 or co % 8 or not (8 <= c <= 64 and 8 <= co <= 64):
        raise ValueError(f"{what}: CUDA kernel needs C and Co in 8..64, multiples of 8, got "
                         f"C={c}, Co={co}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# K7.  Replaces the TPU kernel xview2_tpu/ops/pallas_conv.py::_conv_kernel
# (_conv3x3_fwd_impl).  Bound on the card: bytes (18*C*Co FLOP per pixel
# against 2*(C + Co) bytes in bf16: at C = Co = 32 that is 144 FLOP per byte,
# below the card's 295).  All 9C x Co weights stay in shared memory for the
# block's rows and a ring of three staged input rows feeds the tensor cores.
def small_conv_fwd(x: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    """The conv kernel on a CUDA tensor: x (B, H, W, C), kmat (9C, Co)."""
    if not x.is_cuda:
        raise ValueError("small_conv_fwd needs a CUDA tensor")
    if x.dim() != 4 or kmat.dim() != 2 or kmat.shape[0] != 9 * x.shape[3]:
        raise ValueError(f"small_conv_fwd: x must be (B, H, W, C) and kmat (9C, Co), got "
                         f"{tuple(x.shape)} and {tuple(kmat.shape)}")
    b, h, w, c = x.shape
    co = kmat.shape[1]
    _check("small_conv_fwd", x, co)
    km = kmat.to(device=x.device, dtype=x.dtype).contiguous()
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    fn = cuda_build.function("small_conv", "small_conv_fwd", (
        _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _PTR))
    err = fn(x.data_ptr(), km.data_ptr(), out.data_ptr(), b, h, w, c, co, _DTYPE_CODE[x.dtype],
             _stream(x))
    small_conv_fwd.launches += 1
    cuda_build.check(err, "small_conv_fwd")
    return out


small_conv_fwd.launches = 0


# K8.  Replaces the TPU kernel xview2_tpu/ops/pallas_conv.py::_wgrad_kernel
# (_conv3x3_wgrad_impl), which adds into one resident (9C, Co) output over a
# sequential grid.  Bound on the card: bytes (x and g read once).  Here the
# pixels are split over blocks that keep their part of dW in registers and
# add it into the zeroed output with float32 atomics, so dW is reproducible
# only up to the float32 order of those sums (held at 1e-3 of max |dW|).
def small_conv_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The dW kernel on CUDA tensors: x (B, H, W, C), g (B, H, W, Co) ->
    float32 (9C, Co)."""
    if not (x.is_cuda and g.is_cuda):
        raise ValueError("small_conv_wgrad needs CUDA tensors")
    if g.dim() != 4 or g.shape[:3] != x.shape[:3] or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"small_conv_wgrad: g must be {tuple(x.shape[:3])} + (Co,) {x.dtype} on "
                         f"{x.device}, got {tuple(g.shape)} {g.dtype} on {g.device}")
    co = g.shape[3]
    _check("small_conv_wgrad", x, co)
    _check("small_conv_wgrad (g)", g, x.shape[3])
    b, h, w, c = x.shape
    out = torch.zeros((9 * c, co), dtype=torch.float32, device=x.device)
    fn = cuda_build.function("small_conv", "small_conv_wgrad", (
        _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _PTR))
    err = fn(x.data_ptr(), g.data_ptr(), out.data_ptr(), b, h, w, c, co, _DTYPE_CODE[x.dtype],
             _stream(x))
    small_conv_wgrad.launches += 1
    cuda_build.check(err, "small_conv_wgrad")
    return out


small_conv_wgrad.launches = 0


def _fwd(x: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    return small_conv_fwd(x, kmat) if x.is_cuda else reference_conv3x3(x, kmat)


def _wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return small_conv_wgrad(x, g) if x.is_cuda else reference_wgrad(x, g)


class _Conv3x3Small(torch.autograd.Function):
    """The JAX module's ``custom_vjp``: forward K7; backward K7 on the
    cotangent with the flipped, IO-transposed kernel, and K8."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return _fwd(x, kernel_to_mat(kernel).to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            k_flip = kernel.flip(0, 1).permute(0, 1, 3, 2)  # (3, 3, Co, C)
            dx = _fwd(g, kernel_to_mat(k_flip).to(g.dtype)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dk = mat_to_kernel(_wgrad(x, g), kernel.shape[2]).to(kernel.dtype)
        return dx, dk


def conv3x3_small(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 stride-1 conv through the small-channel kernels.

    ``x``: (B, H, W, C); ``kernel``: (3, 3, C, Co) HWIO.  Differentiable in
    both.  The CUDA kernels take any H and W (:func:`supported` keeps the
    JAX module's rule)."""
    if x.dim() != 4 or kernel.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_small: x must be (B, H, W, C) and kernel (3, 3, C, Co), got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    return _Conv3x3Small.apply(x.contiguous(), kernel)


def supported(x_shape: Tuple[int, ...], c_out: int) -> bool:
    """Static eligibility, copied from the JAX module.  The channel rule
    (``C, Co <= 64``, multiples of 8) is the CUDA kernels' too; ``w % 128``,
    ``h % 8`` and ``h >= 16`` are the TPU's tile limits (lane and sublane
    tiles, two stacked 8-row views), which the CUDA kernels do not have."""
    if len(x_shape) != 4:
        return False
    _, h, w, c = x_shape
    return (c <= 64 and c_out <= 64 and c % 8 == 0 and c_out % 8 == 0
            and w % 128 == 0 and h % 8 == 0 and h >= 16)
