"""Fused conv+BN forward and fused packed head (port of
``xview2_tpu/ops/packed_fused_conv.py``, forward kernels only).

``conv_bn_fused`` computes, in one pass over the previous layer's RAW conv
output: the previous layer's folded BN affine + LeakyReLU (the prologue,
re-zeroing the SAME halo), a 3x3 SAME conv with f32 accumulation cast to the
input dtype, and the per-channel sums s1 = sum(out), s2 = sum(out^2) over the
cast output, from which the caller derives BN statistics.
``head_conv_fused`` is the prologue followed by the packed 1x1 head GEMM and
its bias.  The decoder tail (``models/layers.py``) routes through them under
``fused_tail_scope``.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fused_conv.cu``, ``csrc/fused_head.cu``) and raises on anything the
kernel does not take; on a CPU tensor it runs the plain PyTorch version,
``reference_conv_bn`` / ``reference_head``, which the tests hold against the
JAX package and ``chip_smoke.py`` holds the kernels against on the card.

The backward kernels of the JAX module (``_wgrad_kernel``, ``_dgrad_kernel``)
belong to the train slice and are not ported yet (ROADMAP Queue 2).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from xview2_tpu_torch.ops import cuda_build

HC = 8  # row block of the JAX kernel; only supported() still reads it
LEAKY_SLOPE = 0.01

Fold = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def stat_dtype(dt: torch.dtype) -> torch.dtype:
    """BN-sum dtype: float32 floor, float64 kept (the parity instrument)."""
    return torch.promote_types(dt, torch.float32)


def leaky_slope(dt: torch.dtype) -> float:
    """LeakyReLU slope as JAX applies it: the weakly typed 0.01 takes the
    compute dtype, so bf16 maps multiply by bf16(0.01) = 0.010009765625."""
    return float(torch.tensor(LEAKY_SLOPE, dtype=dt))


def prologue(xprev: torch.Tensor, fold: Optional[Fold]) -> torch.Tensor:
    """The activated input the conv consumes (JAX ``_prologue``): fold
    affine in the input dtype from f32 vectors, then LeakyReLU."""
    if fold is None:
        return xprev
    mean, mul, bias = fold
    dt = xprev.dtype
    y = (xprev - mean.to(dt)) * mul.to(dt) + bias.to(dt)
    return F.leaky_relu(y, leaky_slope(dt))


def conv3x3_nhwc(a: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of an NHWC map with an HWIO kernel, as a library call
    (channels-last NCHW views, no copies)."""
    out = F.conv2d(a.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def reference_conv_bn(xprev: torch.Tensor, kernel: torch.Tensor,
                      fold: Optional[Fold]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``conv_bn_fused``: prologue, conv in the compute
    dtype, sums over the cast output."""
    a = prologue(xprev, fold)
    out = conv3x3_nhwc(a, kernel.to(a.dtype)).to(xprev.dtype)
    of = out.to(stat_dtype(out.dtype))
    return out, of.sum(dim=(0, 1, 2)), (of * of).sum(dim=(0, 1, 2))


def reference_head(x: torch.Tensor, kmat: torch.Tensor, hbias: torch.Tensor,
                   fold: Fold) -> torch.Tensor:
    """Plain version of ``head_conv_fused``: prologue, 1x1 GEMM in the
    compute dtype, cast, then the bias added in the output dtype."""
    a = prologue(x, fold)
    out = torch.matmul(a, kmat.to(a.dtype))
    return out.to(x.dtype) + hbias.to(x.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous NHWC")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned")


def _fold_matrix(fold: Fold, c: int, device) -> torch.Tensor:
    vecs = [f.reshape(-1) for f in fold]
    if any(v.numel() != c for v in vecs):
        raise ValueError(f"fold vectors must have {c} entries")
    return torch.stack(vecs).to(device=device, dtype=torch.float32).contiguous()


def _conv_bn_cuda(xprev: torch.Tensor, kernel: torch.Tensor, fold: Optional[Fold]):
    _check_cuda_input(xprev, "conv_bn_fused")
    b, h, w, c = xprev.shape
    if kernel.shape[:3] != (3, 3, c):
        raise ValueError(f"conv_bn_fused: kernel must be (3, 3, {c}, Co), got {tuple(kernel.shape)}")
    co = kernel.shape[3]
    if co % 64 or c % (32 if xprev.dtype == torch.bfloat16 else 16):
        raise ValueError(f"conv_bn_fused: CUDA kernel needs Co % 64 == 0 and C % 32 (bf16) "
                         f"or % 16 (f32) == 0, got C={c}, Co={co}")
    kmat = kernel.reshape(9 * c, co).to(device=xprev.device, dtype=xprev.dtype).contiguous()
    fmat = None if fold is None else _fold_matrix(fold, c, xprev.device)
    out = torch.empty((b, h, w, co), dtype=xprev.dtype, device=xprev.device)
    s1 = torch.zeros((co,), dtype=torch.float32, device=xprev.device)
    s2 = torch.zeros((co,), dtype=torch.float32, device=xprev.device)
    fn = cuda_build.function("fused_conv", "conv_bn_fused", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p))
    err = fn(xprev.data_ptr(), kmat.data_ptr(), None if fmat is None else fmat.data_ptr(),
             out.data_ptr(), s1.data_ptr(), s2.data_ptr(), b, h, w, c, co,
             _DTYPE_CODE[xprev.dtype], torch.cuda.current_stream(xprev.device).cuda_stream)
    conv_bn_fused.launches += 1
    cuda_build.check(err, "conv_bn_fused")
    return out, s1, s2


def conv_bn_fused(xprev: torch.Tensor, kernel: torch.Tensor, fold: Fold,
                  has_fold: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused [fold+LeakyReLU prologue] + 3x3 SAME conv + BN-sum epilogue.

    ``xprev``: (B, H, W, C) raw conv output of the previous layer;
    ``kernel``: (3, 3, C, Co) HWIO; ``fold``: f32 ``(mean, mul, bias)``
    vectors of the previous layer's BN, ignored when ``has_fold`` is False
    (first layer of a chain: the input is consumed as it is).  Returns
    ``(out, s1, s2)``: the conv output in x's dtype and its f32 per-channel
    sum and sum of squares over batch and space.
    """
    f = fold if has_fold else None
    if xprev.is_cuda:
        return _conv_bn_cuda(xprev, kernel, f)
    return reference_conv_bn(xprev, kernel, f)


conv_bn_fused.launches = 0


def _head_cuda(x: torch.Tensor, kmat: torch.Tensor, hbias: torch.Tensor, fold: Fold):
    _check_cuda_input(x, "head_conv_fused")
    b, h, w, c = x.shape
    co = kmat.shape[-1]
    if kmat.shape != (c, co) or hbias.shape != (co,):
        raise ValueError(f"head_conv_fused: kmat must be ({c}, Co) and hbias (Co,), got "
                         f"{tuple(kmat.shape)} and {tuple(hbias.shape)}")
    if co not in (4, 8, 12, 16, 32, 64) or (c * x.element_size()) % 16:
        raise ValueError(f"head_conv_fused: CUDA kernel needs Co in (4, 8, 12, 16, 32, 64) and "
                         f"16-byte pixel rows, got C={c}, Co={co}")
    k32 = kmat.to(device=x.device, dtype=torch.float32).contiguous()  # rounded to T in the kernel
    hb32 = hbias.to(device=x.device, dtype=torch.float32).contiguous()
    fmat = _fold_matrix(fold, c, x.device)
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    fn = cuda_build.function("fused_head", "head_conv_fused", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    err = fn(x.data_ptr(), k32.data_ptr(), fmat.data_ptr(), hb32.data_ptr(), out.data_ptr(),
             b * h * w, c, co, _DTYPE_CODE[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    head_conv_fused.launches += 1
    cuda_build.check(err, "head_conv_fused")
    return out


def head_conv_fused(x: torch.Tensor, kmat: torch.Tensor, hbias: torch.Tensor,
                    fold: Fold) -> torch.Tensor:
    """Fused [fold+LeakyReLU prologue] + 1x1 head GEMM + bias.

    ``x``: (B, H, W, C) raw conv output of the chain's last layer; ``kmat``:
    (C, Co) packed head matrix; ``hbias``: (Co,) packed bias; ``fold``: the
    last layer's (mean, mul, bias).  The activated map never exists in
    device memory.
    """
    if x.is_cuda:
        return _head_cuda(x, kmat, hbias, fold)
    return reference_head(x, kmat, hbias, fold)


head_conv_fused.launches = 0


def supported(x_shape: Tuple[int, ...], c_out: int, itemsize: int = 2) -> bool:
    """Static eligibility, copied unchanged from the JAX module so that the
    same layers take the fused route.  Its budgets are the TPU kernel's VMEM
    budgets (revisiting them for the card is open work, ROADMAP)."""
    if len(x_shape) != 4:
        return False
    _, h, w, c = x_shape
    if (c % 128 or c_out % 128 or h % HC or h < 16 or w < 8):
        return False
    weights = 9 * c * c_out * itemsize
    rows = 2 * HC * (w + 8) * c * itemsize  # two stacked row-block views
    acc = HC * w * c_out * 4
    wgrad_acc = 9 * c * c_out * 4
    return (weights <= (6 << 20) and wgrad_acc <= (7 << 20)
            and rows + acc <= (8 << 20))
