"""The control's lower precision: float8, the step below bfloat16, in the
usual recipe of float8 training: every tensor that the bfloat16 reference
rounds to bfloat16 (each convolution's operands and output, each
BatchNorm's output, each elementwise result) is instead scaled by its
format's largest value over the tensor's largest magnitude, rounded to
float8 e4m3 and scaled back; in the backward each gradient reaching such a
tensor is rounded the same way to float8 e5m2.  Products still sum in
float32, as an fp8 matrix unit's do."""

from __future__ import annotations

import torch

FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(t: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = FORMATS[fmt] / amax
    return ((t.float() * scale).to(fmt).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)
