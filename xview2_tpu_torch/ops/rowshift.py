"""Per-line fractional shift of packed channels (port of
``xview2_tpu/ops/rowshift.py``), the inner loop of AutoAugment's shears,
translations and three-shear rotation.

``row_shift(x, shift, sel, axis=2)`` on a batch ``x`` of ``(B, H, W, C)``
float32 maps computes, along the W axis with one shift per row,

    out[b, i, j, c] = x[b, i, j + shift[b, i], c]

from the two taps at ``k = floor(s)`` and ``k + 1`` with ``f = s - k``: the
lerp ``lo*(1 - f) + hi*f`` where ``sel[b]`` is set (shears), else the nearest
tap, half-up (``hi`` where ``f >= 0.5``).  The LAST channel (the segmentation
mask) always takes the nearest tap.  A source coordinate ``j + s`` outside
``[0, W - 1]`` gives zero, and so does a tap outside the map (there ``f`` is
0, so nothing else changes).  With ``axis=1`` the shift runs along H with one
shift per column (``shift`` is ``(B, W)``): the vertical shears and the middle
pass of the rotation, which the JAX package transposes around its kernel.

The TPU kernel's lane roll, its ``(H, C, Wp)`` layout, the zero padding to
``W + 2*pad`` and the ``|shift| <= pad - 1`` precondition are Mosaic's and are
not carried over: the CUDA kernel (``csrc/rowshift.cu``) indexes the two taps
directly and takes any shift.  It computes the lerp without FMA contraction,
so the kernel and the plain version agree bit for bit.

On a CPU tensor the plain version (:func:`row_shift_reference`, a
``torch.gather`` form of the JAX module's XLA path) runs; a CUDA tensor
always goes to the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from xview2_tpu_torch.ops import cuda_build


def _check(x: torch.Tensor, shift: torch.Tensor, sel: torch.Tensor, axis: int) -> None:
    if axis not in (1, 2):
        raise ValueError(f"row_shift: axis must be 1 (along H) or 2 (along W), got {axis}")
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"row_shift: x must be (B, H, W, C) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    lines = x.shape[3 - axis]
    if shift.shape != (x.shape[0], lines) or shift.dtype != torch.float32:
        raise ValueError(f"row_shift: shift must be ({x.shape[0]}, {lines}) float32 for axis "
                         f"{axis}, got {tuple(shift.shape)} {shift.dtype}")
    if sel.shape != (x.shape[0],):
        raise ValueError(f"row_shift: sel must be ({x.shape[0]},), got {tuple(sel.shape)}")


def row_shift_reference(x: torch.Tensor, shift: torch.Tensor, sel: torch.Tensor,
                        axis: int = 2) -> torch.Tensor:
    """Plain version: two clamped gathers along the shifted axis."""
    _check(x, shift, sel, axis)
    if axis == 1:
        return row_shift_reference(x.transpose(1, 2), shift, sel, 2).transpose(1, 2)
    b, h, w, c = x.shape
    k = torch.floor(shift)
    f = (shift - k)[:, :, None, None]
    col = torch.arange(w, dtype=torch.float32, device=x.device)
    lo_idx = torch.arange(w, device=x.device)[None, None, :] + k.long()[:, :, None]

    def tap(idx: torch.Tensor) -> torch.Tensor:
        got = torch.gather(x, 2, idx.clamp(0, w - 1)[..., None].expand(b, h, w, c))
        return torch.where(((idx >= 0) & (idx < w))[..., None], got, torch.zeros_like(got))

    lo, hi = tap(lo_idx), tap(lo_idx + 1)
    soft = lo * (1.0 - f) + hi * f
    near = torch.where(f >= 0.5, hi, lo)
    out = torch.where(sel.bool()[:, None, None, None], soft, near)
    out = torch.cat([out[..., :-1], near[..., -1:]], dim=-1)
    src = col[None, None, :] + shift[:, :, None]
    inb = (src >= 0) & (src <= w - 1)
    return torch.where(inb[..., None], out, torch.zeros_like(out))


# K6.  Replaces the TPU kernel xview2_tpu/ops/rowshift.py::_kernel
# (row_shift_pallas).  Bound on the card: bytes (one read and one write of the
# map).  One thread per output pixel for all its channels, 16-byte loads and
# stores at C = 4.  A launch on a few 512^2 samples takes the card about as
# long as the host takes to enqueue it, so the wrapper does only what it must
# per call (as K1's): one cached entry point, scalar arguments, the stream by
# device index, ``empty_like``, and no copy or cast of an input that is
# already right.
_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def row_shift_cuda(x: torch.Tensor, shift: torch.Tensor, sel: torch.Tensor,
                   axis: int = 2) -> torch.Tensor:
    """The row-shift kernel on CUDA tensors (``x`` contiguous)."""
    index = x.get_device()  # -1 on the CPU
    if index < 0 or shift.get_device() != index or sel.get_device() != index:
        raise ValueError("row_shift_cuda needs x, shift and sel on one CUDA device")
    if x.dtype is not torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"row_shift_cuda: x must be contiguous (B, H, W, C) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, h, w, c = x.shape
    if axis == 2:
        lines = h
    elif axis == 1:
        lines = w
    else:
        raise ValueError(f"row_shift: axis must be 1 (along H) or 2 (along W), got {axis}")
    if shift.dtype is not torch.float32 or shift.shape != (b, lines) or sel.shape != (b,):
        _check(x, shift, sel, axis)  # raises with the reason
    if x.numel() >= 2 ** 31:
        raise ValueError(f"row_shift_cuda: at most 2^31 - 1 elements, got {x.numel()}")
    if not shift.is_contiguous():
        shift = shift.contiguous()
    if sel.dtype is not torch.int32 or not sel.is_contiguous():
        sel = sel.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    err = cuda_build.function("rowshift", "row_shift", _ARGS)(
        x.data_ptr(), shift.data_ptr(), sel.data_ptr(), out.data_ptr(), b, h, w, c, axis,
        torch.cuda.current_stream(index).cuda_stream)
    row_shift_cuda.launches += 1
    if err:
        cuda_build.check(err, "row_shift")
    return out


row_shift_cuda.launches = 0


def row_shift(x: torch.Tensor, shift: torch.Tensor, sel: torch.Tensor,
              axis: int = 2) -> torch.Tensor:
    """Shift every line of ``x`` (B, H, W, C) float32 by its own fractional
    amount: ``shift`` is ``(B, H)`` for ``axis=2`` (along W) or ``(B, W)`` for
    ``axis=1`` (along H); ``sel`` ``(B,)`` picks lerp (non-zero) or nearest."""
    if x.is_cuda:
        return row_shift_cuda(x if x.is_contiguous() else x.contiguous(), shift, sel, axis)
    return row_shift_reference(x, shift, sel, axis)
