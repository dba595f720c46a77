"""Fused conv+BN (forward and backward) and fused packed head (port of
``xview2_tpu/ops/packed_fused_conv.py``).

``conv_bn_fused`` computes, in one pass over the previous layer's RAW conv
output: the previous layer's folded BN affine + LeakyReLU (the prologue,
re-zeroing the SAME halo), a 3x3 SAME conv with f32 accumulation cast to the
input dtype, and the per-channel sums s1 = sum(out), s2 = sum(out^2) over the
cast output, from which the caller derives BN statistics.
``head_conv_fused`` is the prologue followed by the packed 1x1 head GEMM and
its bias.  The decoder tail (``models/layers.py``) routes through them under
``fused_tail_scope``.

Both are differentiable.  The backward of ``conv_bn_fused`` runs two more
kernels: ``conv_bn_wgrad`` (dW as a float32 ``(9C, Co)`` matrix, the prologue
applied to the raw input inline) and ``conv_bn_dgrad`` (dx with the
prologue's gradient inline, plus the fold cotangents ``dbias``, ``dmul``).
The backward of ``head_conv_fused`` is plain PyTorch, as it is plain XLA in
the JAX module.  K2 adds s1/s2 with atomics, so a second run of the same
forward may sum them in another order: under a whole-step checkpoint the
train step records them in the forward and hands them back in the
recomputation (:func:`sums_tape`), so every fold, and so every ``out``,
is bit-equal to the first forward's.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fused_conv.cu``, ``csrc/fused_conv_bwd.cu``, ``csrc/fused_head.cu``)
and raises on anything the kernel does not take; on a CPU tensor it runs the
plain PyTorch version (``reference_conv_bn``, ``reference_wgrad``,
``reference_dgrad``, ``reference_head``), which the tests hold against the
JAX package and ``chip_smoke.py`` holds the kernels against on the card.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from xview2_tpu_torch.ops import cuda_build

# Row block of the JAX kernels.  Here only supported() reads it, to keep the
# JAX rule; the CUDA kernels tile by their own ROWS and take any H.
HC = 8
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


@contextlib.contextmanager
def full_precision():
    """Keep float32 library convolutions and products in full float32 (the
    card's cuDNN convolutions default to TF32, about three decimal digits),
    so a plain version measures the kernel and not TF32."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def reference_wgrad(xprev: torch.Tensor, g: torch.Tensor, fold: Optional[Fold]) -> torch.Tensor:
    """Plain version of ``conv_bn_wgrad``: ``dW = A^T G`` as a ``(9C, Co)``
    matrix in ``stat_dtype``, rows ``(dy, dx, c)``.  ``A`` is the im2col of
    the activated input (prologue in the compute dtype, SAME halo zero); the
    products of the compute-dtype values are summed in ``stat_dtype``."""
    _, h, w, c = xprev.shape
    co = g.shape[-1]
    sdt = stat_dtype(xprev.dtype)
    a = F.pad(prologue(xprev, fold).to(sdt), (0, 0, 1, 1, 1, 1))
    gm = g.to(sdt).reshape(-1, co)
    with full_precision():
        taps = [a[:, dy:dy + h, dx:dx + w, :].reshape(-1, c).t() @ gm
                for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=0)


def reference_dgrad(g: torch.Tensor, k_flip: torch.Tensor, xprev: torch.Tensor,
                    fold: Optional[Fold]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``conv_bn_dgrad``: ``(dx, dbias, dmul)``.

    ``da`` is the 3x3 SAME conv of ``g`` with ``k_flip`` (``(9Co, C)``, cast
    to g's dtype), summed and KEPT in ``stat_dtype``; then the prologue's
    gradient: the gate from ``y`` recomputed in the compute dtype (0.01 in
    ``stat_dtype`` where ``y < 0``), ``dx = (da*gate*mul)`` cast to x's dtype,
    and the sums ``dbias = sum(da*gate)``, ``dmul = sum(da*gate*(x - mean))``.
    Without a fold ``dx = da`` cast and both sums are zeros."""
    co = g.shape[-1]
    c = k_flip.shape[-1]
    sdt = stat_dtype(g.dtype)
    kf = k_flip.to(g.dtype).reshape(3, 3, co, c)
    with full_precision():
        da = conv3x3_nhwc(g.to(sdt), kf.to(sdt))
    if fold is None:
        z = torch.zeros((c,), dtype=sdt, device=g.device)
        return da.to(xprev.dtype), z, z.clone()
    mean, mul, bias = fold
    dt = xprev.dtype
    xm = xprev - mean.to(dt)
    y = xm * mul.to(dt) + bias.to(dt)
    one = torch.ones((), dtype=sdt, device=g.device)
    gate = torch.where(y.to(sdt) >= 0, one, LEAKY_SLOPE * one)
    dyv = da * gate
    dx = (dyv * mul.to(sdt)).to(dt)
    return dx, dyv.sum(dim=(0, 1, 2)), (dyv * xm.to(sdt)).sum(dim=(0, 1, 2))


def flip_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Co) HWIO -> the ``(9Co, C)`` matrix of the transposed conv:
    both taps reversed, the channel axes swapped."""
    c, co = kernel.shape[2], kernel.shape[3]
    return kernel.flip(0, 1).permute(0, 1, 3, 2).reshape(9 * co, c)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous NHWC")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned")


def _check_channels(what: str, c: int, co: int, dtype: torch.dtype) -> None:
    """The conv kernels' tiling: the reduced channel count in chunks of 32
    (bf16) or 16 (f32), the produced one in tiles of 64."""
    if co % 64 or c % (32 if dtype == torch.bfloat16 else 16):
        raise ValueError(f"{what}: CUDA kernel needs Co % 64 == 0 and C % 32 (bf16) "
                         f"or % 16 (f32) == 0, got C={c}, Co={co}")


def _fold_matrix(fold: Fold, c: int, device) -> torch.Tensor:
    vecs = [f.reshape(-1) for f in fold]
    if any(v.numel() != c for v in vecs):
        raise ValueError(f"fold vectors must have {c} entries")
    return torch.stack(vecs).to(device=device, dtype=torch.float32).contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _conv_bn_cuda(xprev: torch.Tensor, kernel: torch.Tensor, fold: Optional[Fold]):
    _check_cuda_input(xprev, "conv_bn_fused")
    b, h, w, c = xprev.shape
    if kernel.shape[:3] != (3, 3, c):
        raise ValueError(f"conv_bn_fused: kernel must be (3, 3, {c}, Co), got {tuple(kernel.shape)}")
    co = kernel.shape[3]
    _check_channels("conv_bn_fused", c, co, xprev.dtype)
    kmat = kernel.reshape(9 * c, co).to(device=xprev.device, dtype=xprev.dtype).contiguous()
    fmat = None if fold is None else _fold_matrix(fold, c, xprev.device)
    out = torch.empty((b, h, w, co), dtype=xprev.dtype, device=xprev.device)
    s1 = torch.zeros((co,), dtype=torch.float32, device=xprev.device)
    s2 = torch.zeros((co,), dtype=torch.float32, device=xprev.device)
    fn = cuda_build.function("fused_conv", "conv_bn_fused", (
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _PTR))
    err = fn(xprev.data_ptr(), kmat.data_ptr(), None if fmat is None else fmat.data_ptr(),
             out.data_ptr(), s1.data_ptr(), s2.data_ptr(), b, h, w, c, co,
             _DTYPE_CODE[xprev.dtype], _stream(xprev))
    conv_bn_fused.launches += 1
    cuda_build.check(err, "conv_bn_fused")
    return out, s1, s2


_VARIANTS = {
    "conv_bn_fused": ("fused_conv", {
        0: "f32 FMA", 1: "bf16 wmma row tile 8x128 px x 64 ch",
        128: "bf16 wgmma pipelined, tile 2x128 px x 128 ch",
        64: "bf16 wgmma pipelined, tile 4x64 px x 128 ch",
        32: "bf16 wgmma pipelined, tile 8x32 px x 128 ch",
        16: "bf16 wgmma pipelined, tile 16x16 px x 128 ch"}),
    "conv_bn_wgrad": ("fused_conv_bwd", {
        0: "f32 FMA", 1: "bf16 wmma tile 9 taps x 32 x 64",
        2: "bf16 wgmma pipelined, tile 9 taps x 64 x 64, 64-column strips"}),
    "conv_bn_dgrad": ("fused_conv_bwd", {
        0: "f32 FMA", 1: "bf16 wmma row tile 8x128 px x 64 ch",
        128: "bf16 wgmma pipelined, tile 2x128 px x 128 ch",
        64: "bf16 wgmma pipelined, tile 4x64 px x 128 ch",
        32: "bf16 wgmma pipelined, tile 8x32 px x 128 ch",
        16: "bf16 wgmma pipelined, tile 16x16 px x 128 ch"}),
    "head_conv_fused": ("fused_head", {
        0: "per-pixel FMA, 128 px a block",
        1: "bf16 mma.sync persistent, 128 px tiles in a 4-stage cp.async ring",
        2: "bf16 mma.sync persistent, 128 px tiles in a 3-stage cp.async ring (C = 256)"}),
}


def kernel_variant(kernel: str, h: int, w: int, c: int, co: int, dtype: torch.dtype) -> str:
    """Which hand-written kernel the C entry point of ``kernel`` (a key of
    ``_VARIANTS``) launches for this static shape and dtype: the choice
    depends on nothing else.  ``c`` is the input's channels and ``co`` the
    output's for the forward kernels and the weight gradient; for
    ``"conv_bn_dgrad"`` ``c`` is x's (and dx's) and ``co`` g's; the head
    ignores ``h`` and ``w``.  Needs the built library, so it runs only where
    the kernels do."""
    source, names = _VARIANTS[kernel]
    fn = cuda_build.function(source, f"{kernel}_variant", (_INT,) * 5)
    code = fn(h, w, c, co, _DTYPE_CODE[dtype])
    if code not in names:
        raise ValueError(f"{kernel}: no kernel takes H={h}, W={w}, C={c}, Co={co}, {dtype}")
    return names[code]


def _conv_bn_forward(xprev: torch.Tensor, kernel: torch.Tensor, fold: Optional[Fold]):
    if xprev.is_cuda:
        return _conv_bn_cuda(xprev, kernel, fold)
    return reference_conv_bn(xprev, kernel, fold)


# K4.  Replaces the TPU kernel xview2_tpu/ops/packed_fused_conv.py::_wgrad_kernel.
# Bound on the card: operations (18*C*Co FLOP per pixel against 2*(C + Co)
# bytes).  The TPU kernel adds into one resident output over a sequential
# grid; the CUDA kernel splits the pixels over blocks that keep their output
# tile in registers and add it into the zeroed output with f32 atomics, so
# dW is reproducible only up to the f32 order of those sums.
def _wgrad_cuda(xprev: torch.Tensor, g: torch.Tensor, fold: Optional[Fold]) -> torch.Tensor:
    _check_cuda_input(xprev, "conv_bn_wgrad")
    _check_cuda_input(g, "conv_bn_wgrad (g)")
    b, h, w, c = xprev.shape
    co = g.shape[3]
    if g.shape[:3] != (b, h, w) or g.dtype != xprev.dtype or g.device != xprev.device:
        raise ValueError(f"conv_bn_wgrad: g must be ({b}, {h}, {w}, Co) {xprev.dtype} on "
                         f"{xprev.device}, got {tuple(g.shape)} {g.dtype} on {g.device}")
    _check_channels("conv_bn_wgrad", c, co, xprev.dtype)
    fmat = None if fold is None else _fold_matrix(fold, c, xprev.device)
    out = torch.zeros((9 * c, co), dtype=torch.float32, device=xprev.device)
    fn = cuda_build.function("fused_conv_bwd", "conv_bn_wgrad", (
        _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _PTR))
    err = fn(xprev.data_ptr(), g.data_ptr(), None if fmat is None else fmat.data_ptr(),
             out.data_ptr(), b, h, w, c, co, _DTYPE_CODE[xprev.dtype], _stream(xprev))
    conv_bn_wgrad.launches += 1
    cuda_build.check(err, "conv_bn_wgrad")
    return out


def conv_bn_wgrad(xprev: torch.Tensor, g: torch.Tensor, fold: Fold,
                  has_fold: bool) -> torch.Tensor:
    """Weight gradient of ``conv_bn_fused``: ``(9C, Co)`` in ``stat_dtype``
    (float32 on the card), rows ``(dy, dx, c)``, from the forward's RAW input
    ``xprev`` (the prologue is applied inline) and the cotangent ``g`` of the
    conv output.  The cast to the kernel's dtype is the caller's."""
    f = fold if has_fold else None
    if xprev.is_cuda:
        return _wgrad_cuda(xprev, g, f)
    return reference_wgrad(xprev, g, f)


conv_bn_wgrad.launches = 0


# K5.  Replaces the TPU kernel xview2_tpu/ops/packed_fused_conv.py::_dgrad_kernel.
# Bound on the card: operations.  It is the forward's implicit GEMM on g with
# the flipped kernel; the f32 result is gated and scaled in the epilogue, and
# the fold cotangents, which the TPU kernel sums over its sequential grid, are
# per-block partials added with one atomic per channel.
def _dgrad_cuda(g: torch.Tensor, k_flip: torch.Tensor, xprev: torch.Tensor,
                fold: Optional[Fold]):
    _check_cuda_input(g, "conv_bn_dgrad")
    _check_cuda_input(xprev, "conv_bn_dgrad (xprev)")
    b, h, w, co = g.shape
    c = xprev.shape[3]
    if xprev.shape[:3] != (b, h, w) or xprev.dtype != g.dtype or xprev.device != g.device:
        raise ValueError(f"conv_bn_dgrad: xprev must be ({b}, {h}, {w}, C) {g.dtype} on "
                         f"{g.device}, got {tuple(xprev.shape)} {xprev.dtype} on {xprev.device}")
    if k_flip.shape != (9 * co, c):
        raise ValueError(f"conv_bn_dgrad: k_flip must be ({9 * co}, {c}), got "
                         f"{tuple(k_flip.shape)}")
    _check_channels("conv_bn_dgrad", co, c, g.dtype)
    kf = k_flip.to(device=g.device, dtype=g.dtype).contiguous()
    fmat = None if fold is None else _fold_matrix(fold, c, g.device)
    dx = torch.empty((b, h, w, c), dtype=xprev.dtype, device=g.device)
    dbias = torch.zeros((c,), dtype=torch.float32, device=g.device)
    dmul = torch.zeros((c,), dtype=torch.float32, device=g.device)
    fn = cuda_build.function("fused_conv_bwd", "conv_bn_dgrad", (
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _PTR))
    err = fn(g.data_ptr(), kf.data_ptr(), xprev.data_ptr(),
             None if fmat is None else fmat.data_ptr(), dx.data_ptr(), dbias.data_ptr(),
             dmul.data_ptr(), b, h, w, co, c, _DTYPE_CODE[g.dtype], _stream(g))
    conv_bn_dgrad.launches += 1
    cuda_build.check(err, "conv_bn_dgrad")
    return dx, dbias, dmul


def conv_bn_dgrad(g: torch.Tensor, k_flip: torch.Tensor, xprev: torch.Tensor, fold: Fold,
                  has_fold: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Input gradient of ``conv_bn_fused`` and the fold cotangents:
    ``(dx, dbias, dmul)`` from the cotangent ``g`` of the conv output, the
    flipped kernel ``k_flip`` (:func:`flip_kernel`) and the forward's raw
    input.  ``dx`` has x's dtype, the sums are ``stat_dtype``; without a fold
    they are zeros."""
    f = fold if has_fold else None
    if g.is_cuda:
        return _dgrad_cuda(g, k_flip, xprev, f)
    return reference_dgrad(g, k_flip, xprev, f)


conv_bn_dgrad.launches = 0


_SUMS_TAPE: contextvars.ContextVar = contextvars.ContextVar("xview2_torch_sums_tape",
                                                             default=None)


@contextlib.contextmanager
def sums_tape(tape: list, replay: bool):
    """Append the ``(s1, s2)`` of every ``conv_bn_fused`` call in this scope
    to ``tape``, or, with ``replay``, return the recorded ones in the same
    order in place of the kernel's."""
    tok = _SUMS_TAPE.set((tape, replay, iter(tape) if replay else None))
    try:
        yield
    finally:
        _SUMS_TAPE.reset(tok)


class _ConvBNFused(torch.autograd.Function):
    """``conv_bn_fused`` with the JAX module's custom VJP (``_vjp_fwd`` /
    ``_vjp_bwd`` with ``BWD_PALLAS``): forward K2, backward K4 and K5."""

    @staticmethod
    def forward(ctx, xprev, kernel, mean, mul, bias, has_fold):
        out, s1, s2 = _conv_bn_forward(xprev, kernel, (mean, mul, bias) if has_fold else None)
        taped = _SUMS_TAPE.get()
        if taped is not None:
            tape, replay, recorded = taped
            if replay:
                s1, s2 = next(recorded)
            else:
                tape.append((s1.clone(), s2.clone()))
        ctx.save_for_backward(xprev, kernel, mean, mul, bias, out)
        ctx.has_fold = has_fold
        return out, s1, s2

    @staticmethod
    def backward(ctx, g_out, g_s1, g_s2):
        xprev, kernel, mean, mul, bias, out = ctx.saved_tensors
        fold = (mean, mul, bias) if ctx.has_fold else None
        # the epilogue s1 = sum(out_f32), s2 = sum(out_f32^2) folds back onto
        # the conv output, cast to the primal dtype
        of = out.to(stat_dtype(out.dtype))
        g_conv = (g_out + (g_s1 + 2.0 * of * g_s2).to(g_out.dtype)).contiguous()
        need_x, need_k = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        need_fold = ctx.has_fold and any(ctx.needs_input_grad[2:5])
        dk = dxprev = dmean = dmul = dbias = None
        if need_k:
            dk = conv_bn_wgrad(xprev, g_conv, fold, ctx.has_fold)
            dk = dk.reshape(kernel.shape).to(kernel.dtype)
        if need_x or need_fold:
            dxprev, db, dm = conv_bn_dgrad(g_conv, flip_kernel(kernel), xprev, fold, ctx.has_fold)
            if ctx.has_fold:
                dmean = (-db * mul.to(db.dtype)).to(mean.dtype)
                dmul, dbias = dm.to(mul.dtype), db.to(bias.dtype)
        return dxprev, dk, dmean, dmul, dbias, None


def conv_bn_fused(xprev: torch.Tensor, kernel: torch.Tensor, fold: Fold,
                  has_fold: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused [fold+LeakyReLU prologue] + 3x3 SAME conv + BN-sum epilogue.

    ``xprev``: (B, H, W, C) raw conv output of the previous layer;
    ``kernel``: (3, 3, C, Co) HWIO; ``fold``: f32 ``(mean, mul, bias)``
    vectors of the previous layer's BN, ignored when ``has_fold`` is False
    (first layer of a chain: the input is consumed as it is).  Returns
    ``(out, s1, s2)``: the conv output in x's dtype and its f32 per-channel
    sum and sum of squares over batch and space.  Differentiable in
    ``xprev``, ``kernel`` and the fold (cotangents on all three outputs).
    """
    mean, mul, bias = fold if has_fold else (None, None, None)
    return _ConvBNFused.apply(xprev, kernel, mean, mul, bias, has_fold)


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
        _PTR, _PTR, _PTR, _PTR, _PTR, ctypes.c_longlong, _INT, _INT, _INT, _PTR))
    err = fn(x.data_ptr(), k32.data_ptr(), fmat.data_ptr(), hb32.data_ptr(), out.data_ptr(),
             b * h * w, c, co, _DTYPE_CODE[x.dtype], _stream(x))
    head_conv_fused.launches += 1
    cuda_build.check(err, "head_conv_fused")
    return out


class _HeadConvFused(torch.autograd.Function):
    """``head_conv_fused`` with the JAX module's ``_head_vjp_bwd``: forward
    K3, backward plain PyTorch (the JAX package computes these products
    outside any kernel too)."""

    @staticmethod
    def forward(ctx, x, kmat, hbias, mean, mul, bias):
        fold = (mean, mul, bias)
        ctx.save_for_backward(x, kmat, hbias, mean, mul, bias)
        if x.is_cuda:
            return _head_cuda(x, kmat.to(x.dtype), hbias, fold)
        return reference_head(x, kmat, hbias, fold)

    @staticmethod
    def backward(ctx, g):
        x, kmat, hbias, mean, mul, bias = ctx.saved_tensors
        dt, sdt = x.dtype, stat_dtype(x.dtype)
        c, co = kmat.shape
        a = prologue(x, (mean, mul, bias))
        da = torch.matmul(g, kmat.to(dt).t())
        with full_precision():  # a^T g with the products summed in stat_dtype
            dkmat = a.reshape(-1, c).to(sdt).t() @ g.reshape(-1, co).to(sdt)
        dhbias = g.to(sdt).sum(dim=(0, 1, 2))
        xm = x - mean.to(dt)
        y = xm * mul.to(dt) + bias.to(dt)
        one = torch.ones((), dtype=dt, device=x.device)
        dy = da * torch.where(y >= 0, one, LEAKY_SLOPE * one)
        dx = dy * mul.to(dt)
        dyf = dy.to(sdt)
        dbias = dyf.sum(dim=(0, 1, 2))
        dmul = (dyf * xm.to(sdt)).sum(dim=(0, 1, 2))
        dmean = -dbias * mul.to(sdt)
        return (dx, dkmat.to(kmat.dtype), dhbias.to(hbias.dtype), dmean.to(mean.dtype),
                dmul.to(mul.dtype), dbias.to(bias.dtype))


def head_conv_fused(x: torch.Tensor, kmat: torch.Tensor, hbias: torch.Tensor,
                    fold: Fold) -> torch.Tensor:
    """Fused [fold+LeakyReLU prologue] + 1x1 head GEMM + bias.

    ``x``: (B, H, W, C) raw conv output of the chain's last layer; ``kmat``:
    (C, Co) packed head matrix; ``hbias``: (Co,) packed bias; ``fold``: the
    last layer's (mean, mul, bias).  The activated map never exists in
    device memory.  Differentiable in all of them.
    """
    return _HeadConvFused.apply(x, kmat, hbias, *fold)


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
