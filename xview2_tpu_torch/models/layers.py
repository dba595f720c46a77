"""Decoder building blocks of the xView2 U-Net (port of
``xview2_tpu/models/layers.py``).

Public tensors are NHWC, as in the JAX package; convolutions run on
channels-last NCHW views of them (no copies).  Module and parameter names
follow the flax variable tree, so ``weights.py`` maps one onto the other
mechanically: a flax ``Conv_0/kernel`` is the torch ``Conv_0.weight``, a
``BatchNorm_0/{scale,bias,mean,var}`` is ``BatchNorm_0.{weight,bias,
running_mean,running_var}``.

Every module takes ``train``.  At eval BatchNorm runs as the folded affine
``(x - mean) * mul + bias`` with ``mul = rsqrt(var + eps) * scale`` from the
running statistics (``--fold_eval_bn 1``), applied in the compute dtype from
f32 fold vectors exactly like the JAX ``_norm_act``.  In train mode it uses
batch statistics and updates the running ones IN PLACE (the JAX package
returns a new ``batch_stats`` tree and donates the old state), with torch's
rule: biased variance to normalize, unbiased into ``running_var``.  Under
``fused_tail_scope`` the lane-full decoder ConvBlocks and the s2d-packed
last stage run through the fused conv+BN kernels and the packed head
through the fused head kernel (``ops/packed_fused_conv.py``), forward and
backward.  The decoder options (the attention gate, ``--dec_interp``, PPM,
ASPP, the fine and ``--interpolate`` heads) are plain PyTorch, as they are
plain XLA in the JAX package; their resizes and pools keep JAX's matmul
form with (out, in) weight matrices rounded to the compute dtype.

``--fold_eval_bn 0`` (:func:`fold_eval_bn_scope`, which the eval step
sets) evaluates the stock call sites with flax's eval ``_normalize``
instead: f32 arithmetic on the compute-dtype map, one cast at the end; the
packed and fused tails keep their folds, as in JAX.  ``--remat tail``
(:func:`remat_tail_scope`, which the train step sets) computes each stock
ConvLayer's and ResNet BatchNorm's statistics outside a local
``torch.utils.checkpoint`` region and normalizes inside it (JAX
``_BNStats`` + ``remat_norm_act``), and turns the fused tail off.  Under a
whole-step checkpoint (``--remat dots|full``) the recomputation runs inside
:func:`frozen_running_stats`, so the running statistics update once a step.
Under a data-parallel group (``--gpus N``, ``parallel/mesh.py``) BatchNorm
is sync-BN, as GSPMD makes it in JAX: each statistics point sends its local
sums through ONE ``mesh.global_sum`` and takes the mean, the variance and
Bessel's factor from the global sums over the global count.

JAX counterparts merged here: ``TorchBatchNorm``/``_BNStats``/``_PackedBN``/
``_PackedBNSums`` share one variable tree, so they are one class,
:class:`BatchNorm`, with one method per JAX module;
``_FusedConvLayer``/``_FusedPackedConvLayer`` are the ``forward_fused``
methods of :class:`ConvLayer`/:class:`PackedConvLayer`, and
``PackedGroupConvLayer`` is :class:`PackedConvLayer` with ``groups > 1``.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from xview2_tpu_torch.ops.packed_fused_conv import (Fold, conv3x3_nhwc, conv_bn_fused,
                                                    head_conv_fused, leaky_slope, stat_dtype,
                                                    supported)
from xview2_tpu_torch.parallel import mesh

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax momentum == 1 - torch momentum (torch default 0.1)

_FOLD_EVAL_BN: contextvars.ContextVar = contextvars.ContextVar(
    "xview2_torch_fold_eval_bn", default=True)
_REMAT_TAIL: contextvars.ContextVar = contextvars.ContextVar(
    "xview2_torch_remat_tail", default=False)
_STATS_FROZEN: contextvars.ContextVar = contextvars.ContextVar(
    "xview2_torch_stats_frozen", default=False)


@contextlib.contextmanager
def _scope(var: contextvars.ContextVar, value: bool):
    tok = var.set(value)
    try:
        yield
    finally:
        var.reset(tok)


def fold_eval_bn_scope(enabled: bool = True):
    """Eval-mode BN of the stock call sites as the f32 fold (default) or,
    disabled, as flax's stock eval normalize (``--fold_eval_bn 0``)."""
    return _scope(_FOLD_EVAL_BN, enabled)


def remat_tail_scope(enabled: bool = True):
    """``--remat tail``: normalize+activate inside local checkpoints."""
    return _scope(_REMAT_TAIL, enabled)


def remat_tail_active() -> bool:
    return _REMAT_TAIL.get()


def frozen_running_stats(enabled: bool = True):
    """Leave the BatchNorm running statistics alone (a checkpoint's
    recomputation of a forward that already updated them)."""
    return _scope(_STATS_FROZEN, enabled)


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, padding: int = 0,
              dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight, in ``x``'s dtype (library call)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=stride,
                   padding=padding, dilation=dilation, groups=groups)
    return out.permute(0, 2, 3, 1)


def hwio(weight: torch.Tensor) -> torch.Tensor:
    """OIHW torch conv weight -> the flax HWIO kernel."""
    return weight.permute(2, 3, 1, 0)


def norm_act(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
             act: str) -> torch.Tensor:
    """Folded BN affine in the compute dtype, then the activation (JAX
    ``_norm_act``: each op rounds to x's dtype)."""
    dt = x.dtype
    return _activate((x - mean.to(dt)) * mul.to(dt) + bias.to(dt), act)


def bn_act(bn: "BatchNorm", x: torch.Tensor, train: bool, act: str,
           dtype: torch.dtype, remat_tail: bool = False) -> torch.Tensor:
    """BN + activation of a stock (unfused) call site: batch statistics in
    train mode (with ``remat_tail``, the call sites JAX rematerializes, the
    local checkpoint under :func:`remat_tail_scope`), the eval fold or,
    outside :func:`fold_eval_bn_scope`, the stock eval normalize."""
    if train:
        if remat_tail and remat_tail_active():
            return remat_norm_act(x, bn.train_fold(x), act)
        return _activate(bn.normalize_train(x, dtype), act)
    if _FOLD_EVAL_BN.get():
        return norm_act(x, *bn.fold(), act=act)
    return _activate(bn.normalize_eval(x, dtype), act)


def remat_norm_act(x: torch.Tensor, fold: Fold, act: str) -> torch.Tensor:
    """:func:`norm_act` in a local non-reentrant checkpoint (JAX
    ``remat_norm_act``, a nothing-saveable region): its only saved residual
    is ``x``, the normalized and activated maps are recomputed in the
    backward."""
    return checkpoint(functools.partial(norm_act, act=act), x, *fold, use_reentrant=False,
                      preserve_rng_state=False)


def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "leaky":
        return F.leaky_relu(y, leaky_slope(y.dtype))
    if act == "relu":
        return F.relu(y)
    return y


def conv_bias_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
                   padding: int = 0) -> torch.Tensor:
    """A flax ``nn.Conv(use_bias=True)``: the conv and the bias add in
    ``dtype``."""
    out = conv_nhwc(x.to(dtype), conv.weight, padding=padding)
    return out + conv.bias.to(out.dtype)


# ---------------------------------------------------------------------------
# Resampling in the JAX package's matmul form (JAX layers.py:418-477): two
# products with (out, in) weight matrices, the weights cast to x's dtype.

@functools.lru_cache(maxsize=64)
def _align_corners_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) 1-D linear-interpolation matrix, ``align_corners=True``."""
    w = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        w[0, 0] = 1.0
        return w
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    scale = (in_size - 1) / (out_size - 1)
    pos = np.arange(out_size) * scale
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (pos - lo).astype(np.float32)
    w[np.arange(out_size), lo] += 1.0 - frac
    w[np.arange(out_size), hi] += frac
    return w


@functools.lru_cache(maxsize=64)
def _adaptive_pool_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) averaging matrix of torch's ``adaptive_avg_pool2d`` windows."""
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -(-((i + 1) * in_size) // out_size)  # ceil
        w[i, lo:hi] = 1.0 / (hi - lo)
    return w


def _separable(x: torch.Tensor, wh: np.ndarray, ww: np.ndarray) -> torch.Tensor:
    """``Wh @ x @ Ww^T`` over the H and W axes of an NHWC map."""
    wh_t = torch.from_numpy(wh).to(x.device, x.dtype)
    ww_t = torch.from_numpy(ww).to(x.device, x.dtype)
    x = torch.einsum("oh,bhwc->bowc", wh_t, x)
    return torch.einsum("ow,bhwc->bhoc", ww_t, x)


def interpolate_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with torch's ``align_corners=True`` semantics."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == tuple(out_hw):
        return x
    return _separable(x, _align_corners_weights(h, out_hw[0]),
                      _align_corners_weights(w, out_hw[1]))


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC adaptive average pool with torch's window semantics."""
    return _separable(x, _adaptive_pool_weights(x.shape[1], out_hw[0]),
                      _adaptive_pool_weights(x.shape[2], out_hw[1]))


class BatchNorm(nn.Module):
    """BatchNorm with ``nn.BatchNorm``'s variable tree (JAX ``TorchBatchNorm``,
    ``_PackedBN``, ``_PackedBNSums`` and, at eval, ``_BNStats``).

    Eval: ``fold(phases)`` returns the f32 ``(mean, mul, bias)`` vectors from
    the running statistics, tiled ``phases`` times for s2d-packed maps
    (phase-major channels).  Train: batch statistics with the fast variance
    ``E[x^2] - E[x]^2`` in f32 (f64 kept), the running statistics updated in
    place with flax momentum 0.9 and the UNBIASED variance (``n / (n - 1)``),
    as torch's ``BatchNorm2d`` does."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def fold(self, phases: int = 1) -> Fold:
        return self._fold(self.running_mean, self.running_var, phases)

    def _fold(self, mean: torch.Tensor, var: torch.Tensor, phases: int) -> Fold:
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        vecs = (mean, mul, self.bias)
        return tuple(v.repeat(phases) for v in vecs) if phases > 1 else vecs

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor, n) -> None:
        """``n``: the count of the statistics, an int or (sync-BN) a
        one-element tensor of the global count."""
        if _STATS_FROZEN.get():
            return
        bessel = n / (n - 1).clamp(min=1) if torch.is_tensor(n) else n / max(n - 1, 1)
        self.running_mean.mul_(BN_MOMENTUM).add_(mean.to(self.running_mean.dtype),
                                                 alpha=1 - BN_MOMENTUM)
        self.running_var.mul_(BN_MOMENTUM).add_((var * bessel).to(self.running_var.dtype),
                                                alpha=1 - BN_MOMENTUM)

    def _batch_stats(self, xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """flax ``_compute_stats``: mean and the fast variance, clamped at
        0; updates the running statistics.  Under a group the sum, the sum
        of squares and the count are global."""
        dims = tuple(range(xf.dim() - 1))
        n = xf.numel() // xf.shape[-1]
        if mesh.active() is None:  # flax's mean(), as before data parallelism
            mean = xf.mean(dim=dims)
            var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
        else:
            count = torch.full((1,), n, dtype=xf.dtype, device=xf.device)
            s1, s2, n = mesh.global_sum(xf.sum(dim=dims), (xf * xf).sum(dim=dims), count)
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
        self._update_running(mean, var, n)
        return mean, var

    def normalize_train(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Stock train-mode BN (JAX ``TorchBatchNorm``, i.e. flax's
        ``_compute_stats`` + ``_normalize``): statistics and the normalize
        itself in f32, ONE cast to ``dtype`` at the end (unlike the eval
        fold, which rounds after each op)."""
        xf = x.to(stat_dtype(x.dtype))
        mean, var = self._batch_stats(xf)
        y = (xf - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) + self.bias
        return y.to(dtype)

    def normalize_eval(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Stock eval-mode BN (flax ``_normalize`` with the running
        statistics, ``--fold_eval_bn 0``): f32 arithmetic, one cast."""
        xf = x.to(stat_dtype(x.dtype))
        y = (xf - self.running_mean) * (torch.rsqrt(self.running_var + BN_EPS) * self.weight)
        return (y + self.bias).to(dtype)

    def train_fold(self, x: torch.Tensor) -> Fold:
        """The batch statistics of :meth:`normalize_train` as a fold (JAX
        ``_BNStats`` in train mode, for ``--remat tail``)."""
        mean, var = self._batch_stats(x.to(stat_dtype(x.dtype)))
        return self._fold(mean, var, 1)

    def _packed_stats(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.weight.shape[0]
        xf = x.to(torch.float32)
        n = x.shape[0] * x.shape[1] * x.shape[2] * 4 * mesh.world_size()
        s1, s2 = mesh.global_sum(xf.sum(dim=(0, 1, 2)).reshape(4, c).sum(0),
                                 (xf * xf).sum(dim=(0, 1, 2)).reshape(4, c).sum(0))
        mean = s1 / n
        var = s2 / n - mean * mean
        self._update_running(mean, var, n)
        return mean, var

    def normalize_train_packed(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Train-mode BN over an s2d-packed map (JAX ``_PackedBN``): the sums
        fold the four phase copies of each fine channel (always in f32), the
        normalize runs in the compute dtype, rounding after each op."""
        mean, var = self._packed_stats(x)
        mul = (torch.rsqrt(var + BN_EPS) * self.weight).to(dtype)
        y = (x - mean.to(dtype).repeat(4)) * mul.repeat(4) + self.bias.to(dtype).repeat(4)
        return y.to(dtype)

    def train_fold_packed(self, x: torch.Tensor) -> Fold:
        """:meth:`normalize_train_packed`'s statistics as a phase-tiled fold
        (JAX ``_PackedBN(emit_fold=True)``, for ``--remat tail``), cast to
        the compute dtype BEFORE the tiling, as the stock route casts: the
        cotangents of the four phase copies then sum as they do there (JAX
        tiles first and sums them in f32)."""
        mean, mul, bias = self._fold(*self._packed_stats(x), 1)
        return tuple(v.to(x.dtype).repeat(4) for v in (mean, mul, bias))

    def fold_from_sums(self, s1: torch.Tensor, s2: torch.Tensor, n: int, phases: int,
                       train: bool) -> Fold:
        """The fold of a fused-chain layer (JAX ``_PackedBNSums``): in train
        mode from the fused kernel's per-channel sums ``(s1, s2)`` over ``n``
        elements per fine channel, else from the running statistics.  Under
        a group the sums are summed over the ranks first (JAX's ``psum`` of
        K2's sums under ``shard_map``) and ``n`` is global."""
        if not train:
            return self.fold(phases)
        s1, s2 = mesh.global_sum(s1, s2)
        n = n * mesh.world_size()
        c = self.weight.shape[0]
        mean = s1.reshape(phases, c).sum(0) / n
        var = s2.reshape(phases, c).sum(0) / n - mean * mean
        self._update_running(mean, var, n)
        return self._fold(mean, var, phases)


# ---------------------------------------------------------------------------
# Fused decoder tail (JAX layers.py:251-331).  Under ``fused_tail_scope`` the
# eligible decoder blocks route through the fused conv+BN kernel: each layer
# reads the previous RAW conv output and applies its fold inline.  With
# ``defer_head`` the packed chain's final fold is not applied at all: the
# block returns a DeferredFold and the packed head consumes it through the
# fused head kernel, so the activated map never exists in device memory.
_FUSED_TAIL: contextvars.ContextVar = contextvars.ContextVar(
    "xview2_torch_fused_tail", default=(False, None))


class DeferredFold:
    """A raw fused-chain conv output paired with its pending BN fold; any
    consumer must unwrap it with :func:`consume_fold`."""

    __slots__ = ("raw", "fold")

    def __init__(self, raw: torch.Tensor, fold: Fold):
        self.raw = raw
        self.fold = fold


def fused_tail_state():
    return _FUSED_TAIL.get()


def defer_fold(raw: torch.Tensor, fold: Fold) -> DeferredFold:
    """Wrap a raw output + fold and track it for the unconsumed assertion."""
    _, outstanding = fused_tail_state()
    carrier = DeferredFold(raw, fold)
    outstanding.append(carrier)
    return carrier


def consume_fold(x) -> Tuple[torch.Tensor, Optional[Fold]]:
    """Unwrap a :class:`DeferredFold` (marking it consumed); identity on
    plain tensors."""
    if not isinstance(x, DeferredFold):
        return x, None
    _, outstanding = fused_tail_state()
    if outstanding is not None and any(c is x for c in outstanding):
        outstanding.remove(x)
    return x.raw, x.fold


@contextlib.contextmanager
def fused_tail_scope(enabled: bool = True, defer_head: bool = False):
    """Route the eligible decoder blocks through the fused kernels."""
    outstanding: Optional[List[DeferredFold]] = [] if (enabled and defer_head) else None
    tok = _FUSED_TAIL.set((enabled, outstanding))
    try:
        yield outstanding
    finally:
        _FUSED_TAIL.reset(tok)
    if outstanding:
        raise AssertionError(
            "fused-tail deferred fold was never consumed by a packed head; "
            "defer_head needs dec5 to reach the packed head unchanged or through "
            "concat_registered of two deferred branches")


def concat_registered(a, b):
    """Channel concat of two branch maps (JAX ``concat_registered``).  When
    both are :class:`DeferredFold` carriers it concatenates the raw maps and
    the fold vectors (the prologue affine is per channel, so this is exact)
    and returns one carrier for the packed head; one carrier beside a plain
    map raises."""
    da, db = isinstance(a, DeferredFold), isinstance(b, DeferredFold)
    if da and db:
        ra, fa = consume_fold(a)
        rb, fb = consume_fold(b)
        fold = tuple(torch.cat([va, vb]) for va, vb in zip(fa, fb))
        return defer_fold(torch.cat([ra, rb], dim=-1), fold)
    if da or db:
        raise AssertionError("asymmetric deferred folds at a branch concat; defer_head "
                             "requires both branches to end in fused packed chains")
    return torch.cat([a, b], dim=-1)


def _zero_fold(c: int, dtype: torch.dtype, device) -> Fold:
    z = torch.zeros((c,), dtype=stat_dtype(dtype), device=device)
    return z, z, z


class ConvLayer(nn.Module):
    """3x3 conv (no bias) + BN + LeakyReLU(0.01) (JAX ``ConvLayer``)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_features, features, 3, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv_nhwc(x.to(self.dtype), self.Conv_0.weight, padding=1)
        return bn_act(self.BatchNorm_0, x, train, "leaky", self.dtype, remat_tail=True)

    def forward_fused(self, xprev: torch.Tensor, fold: Fold, has_fold: bool, n: int,
                      train: bool) -> Tuple[torch.Tensor, Fold]:
        """JAX ``_FusedConvLayer``: RAW conv output + this layer's fold."""
        out, s1, s2 = conv_bn_fused(xprev.to(self.dtype),
                                    hwio(self.Conv_0.weight).to(self.dtype), fold, has_fold)
        return out, self.BatchNorm_0.fold_from_sums(s1, s2, n, 1, train)


class ConvBlock(nn.Module):
    """Two stacked ConvLayers (JAX ``ConvBlock``).  Under
    ``fused_tail_scope`` a lane-full block (dec_l2/dec_l3) runs both convs
    through the fused kernel; only the final fold is an elementwise pass."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.conv1 = ConvLayer(in_features, features, dtype)
        self.conv2 = ConvLayer(features, features, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        fused, _ = fused_tail_state()
        if fused and not remat_tail_active():
            it = torch.finfo(self.dtype).bits // 8
            mid = (x.shape[0], x.shape[1], x.shape[2], self.features)
            # both-or-nothing, as in JAX (dec_l1's conv1 weights exceed the budget)
            if supported(tuple(x.shape), self.features, it) and \
                    supported(mid, self.features, it):
                n = x.shape[0] * x.shape[1] * x.shape[2]
                zero = _zero_fold(x.shape[-1], self.dtype, x.device)
                out1, fold1 = self.conv1.forward_fused(x, zero, False, n, train)
                out2, fold2 = self.conv2.forward_fused(out1, fold1, True, n, train)
                return norm_act(out2, *fold2, act="leaky")
        return self.conv2(self.conv1(x, train), train)


def _convt_matmul(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """k2s2 transposed conv as one GEMM: (B, H, W, Cin) -> (B, H, W, 4*Cout)
    with phase-major output channels ``(kh*2 + kw)*Cout + o``.  ``weight`` is
    torch ConvTranspose2d's (Cin, Cout, 2, 2)."""
    cin, cout = weight.shape[0], weight.shape[1]
    kmat = weight.permute(0, 2, 3, 1).reshape(cin, 4 * cout).to(dtype)
    return torch.matmul(x.to(dtype), kmat)


class ConvTranspose(nn.Module):
    """2x2 stride-2 transposed conv, no bias (JAX ``ConvTranspose``; the
    flax kernel (kh, kw, out, in) is torch's (in, out, kh, kw), no flip)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_features, features, 2, 2))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        cout = self.weight.shape[1]
        y = _convt_matmul(x, self.weight, self.dtype).reshape(b, h, w, 2, 2, cout)
        return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, cout)


class AttentionLayer(nn.Module):
    """1x1 conv (no bias) + BN, no activation (JAX ``AttentionLayer``)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_features, features, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv_nhwc(x.to(self.dtype), self.Conv_0.weight)
        return bn_act(self.BatchNorm_0, x, train, "none", self.dtype)


class UpsampleBlock(nn.Module):
    """Decoder stage: upsample, the optional additive attention gate on the
    skip, concat with the skip, ConvBlock (JAX ``UpsampleBlock``).

    The upsample is the k2s2 transposed conv, or with ``dec_interp`` a 3x3
    conv with bias and a bilinear 2x resize (align corners).  ``attention``
    (stages with a skip only) gates the skip by ``sigmoid(psi(relu(conv_o(out)
    + conv_s(skip))))`` with ``features // 2`` gate channels and one ``psi``
    channel.  ``packed_out``: the output stays s2d-packed (B, H, W,
    4*features), phase-major: the k2s2 transposed conv's four output phases
    ARE the s2d phases, so the upsample is one dense GEMM and no interleave
    happens."""

    def __init__(self, in_features: int, features: int, skip_channels: int,
                 packed_out: bool, dtype: torch.dtype, attention: bool = False,
                 dec_interp: bool = False):
        super().__init__()
        if packed_out and (skip_channels or dec_interp):
            raise ValueError("the packed last stage has no skip connection and no interpolation")
        self.skip_channels, self.packed_out = skip_channels, packed_out
        self.dtype, self.dec_interp = dtype, dec_interp
        self.attention = attention and bool(skip_channels)
        if dec_interp:
            self.conv = nn.Conv2d(in_features, features, 3, padding=1, bias=True)
        else:
            self.conv_transpose = ConvTranspose(in_features, features, dtype)
        if self.attention:
            att = features // 2
            self.conv_o = AttentionLayer(features, att, dtype)
            self.conv_s = AttentionLayer(skip_channels, att, dtype)
            self.psi = AttentionLayer(att, 1, dtype)
        if packed_out:
            self.conv_block = PackedConvBlock(features, features, dtype)
        else:
            self.conv_block = ConvBlock(features + skip_channels, features, dtype)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                train: bool = False):
        if self.packed_out:
            ct = self.conv_transpose
            return self.conv_block(_convt_matmul(x, ct.weight, ct.dtype), train)
        if self.dec_interp:
            out = conv_bias_nhwc(x, self.conv, self.dtype, padding=1)
            out = interpolate_bilinear(out, (2 * out.shape[1], 2 * out.shape[2]))
        else:
            out = self.conv_transpose(x)
        if not self.skip_channels:
            return self.conv_block(out, train)
        if self.attention:
            gate = F.relu(self.conv_o(out, train) + self.conv_s(skip, train))
            skip = skip * torch.sigmoid(self.psi(gate, train))
        return self.conv_block(torch.cat([out, skip], dim=-1), train)


class PPM(nn.Module):
    """Pyramid pooling (JAX ``PPM``): for each bin of (1, 2, 3, 6) an
    adaptive average pool, a 1x1 conv ``reduce{i}`` (no bias) to C/4
    channels, ``bn{i}`` and LeakyReLU, and a bilinear resize back; the input
    and the four branches concatenated, then the 1x1 ``fuse`` conv with bias
    back to C channels."""

    BINS = (1, 2, 3, 6)

    def __init__(self, in_features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        out = in_features // 4
        for i in range(len(self.BINS)):
            self.add_module(f"reduce{i}", nn.Conv2d(in_features, out, 1, bias=False))
            self.add_module(f"bn{i}", BatchNorm(out))
        self.fuse = nn.Conv2d(2 * in_features, in_features, 1, bias=True)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        feats = [x]
        for i, b in enumerate(self.BINS):
            f = conv_nhwc(adaptive_avg_pool(x, (b, b)).to(self.dtype),
                          getattr(self, f"reduce{i}").weight)
            f = bn_act(getattr(self, f"bn{i}"), f, train, "leaky", self.dtype)
            feats.append(interpolate_bilinear(f, (h, w)))
        return conv_bias_nhwc(torch.cat(feats, dim=-1), self.fuse, self.dtype)


class ASPPModule(nn.Module):
    """One atrous branch: conv (no bias, kaiming-normal init) + BN +
    LeakyReLU (JAX ``ASPPModule``)."""

    def __init__(self, in_features: int, features: int, kernel_size: int, dilation: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype, self.dilation = dtype, dilation
        self.padding = 0 if kernel_size == 1 else dilation
        self.Conv_0 = nn.Conv2d(in_features, features, kernel_size, padding=self.padding,
                                dilation=dilation, bias=False)
        nn.init.kaiming_normal_(self.Conv_0.weight, mode="fan_in", nonlinearity="relu")
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv_nhwc(x.to(self.dtype), self.Conv_0.weight, padding=self.padding,
                      dilation=self.dilation)
        return bn_act(self.BatchNorm_0, x, train, "leaky", self.dtype)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (JAX ``ASPP``): branches ``aspp1..4`` at
    dilations 1, 3d, 6d, 9d (the first 1x1), each to C/4 channels; the output
    is their concat, C channels, with no fuse conv."""

    def __init__(self, in_features: int, dilation: int, dtype: torch.dtype):
        super().__init__()
        out = in_features // 4
        self.aspp1 = ASPPModule(in_features, out, 1, 1, dtype)
        self.aspp2 = ASPPModule(in_features, out, 3, 3 * dilation, dtype)
        self.aspp3 = ASPPModule(in_features, out, 3, 6 * dilation, dtype)
        self.aspp4 = ASPPModule(in_features, out, 3, 9 * dilation, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.cat([m(x, train) for m in (self.aspp1, self.aspp2, self.aspp3,
                                                self.aspp4)], dim=-1)


# ---------------------------------------------------------------------------
# Space-to-depth packed decoder tail (JAX layers.py:778-868): the last
# decoder stage runs on 2x2 pixel blocks packed into channels, with the SAME
# (3, 3, Ci, Co) parameters embedded as a structurally sparse packed kernel.

def _phase_matrix() -> np.ndarray:
    """M[u, a, d, h]: coarse offset u, in-phase a, out-phase d, fine tap h.
    1 where fine offset 2(u-1)+a-d equals tap h-1 (all indices 0-based)."""
    m = np.zeros((3, 2, 2, 3), np.float32)
    for u in range(3):
        for a in range(2):
            for d in range(2):
                delta = 2 * (u - 1) + a - d
                if -1 <= delta <= 1:
                    m[u, a, d, delta + 1] = 1.0
    return m


_PHASE = _phase_matrix()


def s2d_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """Embed a fine (3, 3, Ci, Co) HWIO kernel as the packed (3, 3, 4Ci, 4Co)
    kernel computing the identical stride-1 SAME conv on s2d(2)-packed
    activations (channel order phase-major ``[p, c]``)."""
    ci, co = w.shape[2], w.shape[3]
    ph = torch.as_tensor(_PHASE, dtype=w.dtype, device=w.device)
    wp = torch.einsum("hwio,uadh,vbew->uvabideo", w, ph, ph)
    return wp.reshape(3, 3, 4 * ci, 4 * co)


def group_major_rows(wp: torch.Tensor, groups: int) -> torch.Tensor:
    """Row-permute a packed kernel (3, 3, 4*groups*cg, Co) from the phase-major
    rows ``[p, g, c]`` of :func:`s2d_conv_kernel` over the whole fine input to
    the group-major rows ``[g, p, c]`` of a concat of ``groups`` packed
    branches (JAX ``PackedGroupConvLayer``)."""
    if groups == 1:
        return wp
    kh, kw, rows, co = wp.shape
    cg = rows // (4 * groups)
    wp = wp.reshape(kh, kw, 4, groups, cg, co).permute(0, 1, 3, 2, 4, 5)
    return wp.reshape(kh, kw, rows, co)


def s2d_head_kernel(w: torch.Tensor, groups: int) -> torch.Tensor:
    """Embed a fine 1x1 head kernel (1, 1, groups*C, n) as the packed
    (1, 1, groups*4C, 4n) block-diagonal-over-phases kernel."""
    fine_in, n = w.shape[2], w.shape[3]
    c = fine_in // groups
    w3 = w.reshape(groups, c, n)
    eye = torch.eye(4, dtype=w.dtype, device=w.device)
    wp = torch.einsum("gco,pq->gpcqo", w3, eye)
    return wp.reshape(1, 1, groups * 4 * c, 4 * n)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4n) phase-major packed -> (B, 2H, 2W, n) fine."""
    b, h, w, p = x.shape
    n = p // 4
    x = x.reshape(b, h, w, 2, 2, n).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, n)


def unview_loss_logits(x: torch.Tensor) -> torch.Tensor:
    """Inverse of the packed loss view: (B, H, 4W, n) -> (B, 2H, 2W, n).

    The loss view (``OutputBlock`` in train mode) is the packed head output
    with the phases merged into the W axis, a pixel permutation of the fine
    logits (index ``j*4 + di*2 + dj``) that the permutation-invariant losses
    consume without a depth-to-space transpose.  For tests and debugging."""
    b, h, w4, n = x.shape
    return depth_to_space(x.reshape(b, h, w4 // 4, 4 * n))


class PackedConvLayer(nn.Module):
    """ConvLayer on s2d-packed activations; variable tree of ``ConvLayer``.
    ``groups > 1`` (JAX ``PackedGroupConvLayer``): the input is the
    group-major concat of that many packed branches, ``in_features`` counts
    the fine channels of all of them, and the packed kernel's rows are
    permuted to match (:func:`group_major_rows`)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype, groups: int = 1):
        super().__init__()
        self.dtype, self.groups = dtype, groups
        self.Conv_0 = nn.Conv2d(in_features, features, 3, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def packed_kernel(self) -> torch.Tensor:
        wp = s2d_conv_kernel(hwio(self.Conv_0.weight))
        return group_major_rows(wp, self.groups).to(self.dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv3x3_nhwc(x.to(self.dtype), self.packed_kernel())
        if train and remat_tail_active():
            return remat_norm_act(x, self.BatchNorm_0.train_fold_packed(x), "leaky")
        if train:
            return _activate(self.BatchNorm_0.normalize_train_packed(x, self.dtype), "leaky")
        return norm_act(x, *self.BatchNorm_0.fold(4), act="leaky")

    def forward_fused(self, xprev: torch.Tensor, fold: Fold, has_fold: bool, n: int,
                      train: bool) -> Tuple[torch.Tensor, Fold]:
        """JAX ``_FusedPackedConvLayer``: RAW conv output + this layer's fold."""
        out, s1, s2 = conv_bn_fused(xprev.to(self.dtype), self.packed_kernel(), fold, has_fold)
        return out, self.BatchNorm_0.fold_from_sums(s1, s2, n, 4, train)


class PackedConvBlock(nn.Module):
    """Two stacked PackedConvLayers (variable tree of ``ConvBlock``)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.conv1 = PackedConvLayer(in_features, features, dtype)
        self.conv2 = PackedConvLayer(features, features, dtype)

    def forward(self, x: torch.Tensor, train: bool = False):
        fused, outstanding = fused_tail_state()
        if fused and not remat_tail_active() and supported(tuple(x.shape), 4 * self.features):
            n = x.shape[0] * x.shape[1] * x.shape[2] * 4  # elements per FINE channel
            zero = _zero_fold(x.shape[-1], self.dtype, x.device)
            out1, fold1 = self.conv1.forward_fused(x, zero, False, n, train)
            out2, fold2 = self.conv2.forward_fused(out1, fold1, True, n, train)
            if outstanding is not None:
                return defer_fold(out2, fold2)
            return norm_act(out2, *fold2, act="leaky")
        return self.conv2(self.conv1(x, train), train)


class FusionBlock(nn.Module):
    """Cross-branch fusion (JAX ``FusionBlock``): run the pre and post
    sub-layers, concatenate the two branches and re-mix them with two
    ConvLayers, ``conv_pre`` and ``conv_post``.  The sub-layers are encoder
    stages, called ``(x, train)``, or decoder stages (``decoder_mode``),
    called ``(x, skip, train)``.

    ``packed_last``: the sub-layers are the s2d-packed last decoder stage, so
    the re-mix is a packed group conv over the concat (``groups=2``).  Under
    ``fused_tail_scope``, where :func:`supported` takes the shape, both group
    convs consume the SAME raw concat and its concatenated fold through the
    fused kernel, and return deferred folds when a registry is open (the
    head's concat joins them), activated maps otherwise.  The stock route
    activates a fold-carrying concat first."""

    def __init__(self, pre_layer: nn.Module, post_layer: nn.Module, features: int,
                 dtype: torch.dtype, decoder_mode: bool = False, packed_last: bool = False):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.decoder_mode, self.packed_last = decoder_mode, packed_last
        self.pre_layer, self.post_layer = pre_layer, post_layer
        if packed_last:
            self.conv_pre = PackedConvLayer(2 * features, features, dtype, groups=2)
            self.conv_post = PackedConvLayer(2 * features, features, dtype, groups=2)
        else:
            self.conv_pre = ConvLayer(2 * features, features, dtype)
            self.conv_post = ConvLayer(2 * features, features, dtype)

    def forward(self, pre, post, dec_pre=None, dec_post=None, last_dec: bool = False,
                train: bool = False):
        if self.decoder_mode and (dec_pre is not None or dec_post is not None or last_dec):
            pre = self.pre_layer(pre, dec_pre, train)
            post = self.post_layer(post, dec_post, train)
        else:
            pre = self.pre_layer(pre, train)
            post = self.post_layer(post, train)
        fmap = concat_registered(pre, post)
        if self.packed_last and last_dec:
            fused, outstanding = fused_tail_state()
            raw_in = fmap.raw if isinstance(fmap, DeferredFold) else fmap
            if fused and not remat_tail_active() and \
                    supported(tuple(raw_in.shape), 4 * self.features):
                raw_in, fold_in = consume_fold(fmap)
                has_fold = fold_in is not None
                if fold_in is None:
                    fold_in = _zero_fold(raw_in.shape[-1], self.dtype, raw_in.device)
                n = raw_in.shape[0] * raw_in.shape[1] * raw_in.shape[2] * 4
                raw_pre, fold_pre = self.conv_pre.forward_fused(raw_in, fold_in, has_fold, n,
                                                                train)
                raw_post, fold_post = self.conv_post.forward_fused(raw_in, fold_in, has_fold, n,
                                                                   train)
                if outstanding is not None:
                    return defer_fold(raw_pre, fold_pre), defer_fold(raw_post, fold_post)
                return (norm_act(raw_pre, *fold_pre, act="leaky"),
                        norm_act(raw_post, *fold_post, act="leaky"))
            if isinstance(fmap, DeferredFold):  # the branch chains returned RAW maps
                raw, fold = consume_fold(fmap)
                fmap = norm_act(raw, *fold, act="leaky")
        return self.conv_pre(fmap, train), self.conv_post(fmap, train)


class PackedHead(nn.Module):
    """1x1 output head in the packed domain (JAX ``_PackedHead``); the
    parameters are the FINE head's.  ``groups``: the input is the
    group-major concat of that many packed branches.  With a deferred
    ``fold`` it runs as the fused head kernel (a zero bias without
    ``use_bias``)."""

    def __init__(self, fine_in: int, head_n: int, groups: int, dtype: torch.dtype,
                 use_bias: bool = True):
        super().__init__()
        self.dtype, self.groups = dtype, groups
        self.weight = nn.Parameter(torch.empty(head_n, fine_in, 1, 1))
        self.bias = nn.Parameter(torch.zeros(head_n)) if use_bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor, fold: Optional[Fold] = None) -> torch.Tensor:
        wp = s2d_head_kernel(hwio(self.weight), self.groups).to(self.dtype)
        kmat = wp.reshape(wp.shape[2], wp.shape[3])
        if fold is not None:
            hbias = (self.bias.repeat(4) if self.bias is not None else
                     torch.zeros(kmat.shape[1], dtype=torch.float32, device=x.device))
            return head_conv_fused(x.to(self.dtype), kmat, hbias, fold)
        out = torch.matmul(x.to(self.dtype), kmat)
        if self.bias is None:
            return out
        return out + self.bias.repeat(4).to(out.dtype)


class OutputBlock(nn.Module):
    """Final 1x1 head (JAX ``OutputBlock``).

    ``packed`` (``packed_in=True, emit_loss_view=True``): the head over the
    s2d-packed tail, the packed 1x1 head, then at eval the depth-to-space of
    the logits, in train mode the loss view ``(B, H, 4W, n)``, a reshape with
    no transpose; ``packed_groups``: concatenated packed branches (2 for
    siamese); ``fine_in`` counts all of them.  Otherwise the fine head: a
    1x1 conv on the fine map, and with ``interpolate`` a bilinear resize
    (align corners) to a FIXED 512^2 in train mode and 1024^2 at eval,
    whatever the input size.

    ``n_class == 3`` is the CORAL head: one logit, no bias, and the shared
    ordinal ``coral_bias`` (initialized to [1, 0, -1]) added to either view,
    broadcasting the logit to 3 channels; ``n_class == 1`` is the MSE head."""

    def __init__(self, n_class: int, fine_in: int, dtype: torch.dtype,
                 packed_groups: int = 1, packed: bool = True, interpolate: bool = False):
        super().__init__()
        if packed and interpolate:
            raise ValueError("--interpolate has no decoder to pack")
        self.coral, self.packed, self.interpolate = n_class == 3, packed, interpolate
        self.dtype = dtype
        head_n = 1 if self.coral else n_class
        if packed:
            self.conv = PackedHead(fine_in, head_n, packed_groups, dtype,
                                   use_bias=not self.coral)
        else:
            self.conv = nn.Conv2d(fine_in, head_n, 1, bias=not self.coral)
            if not self.coral:
                nn.init.zeros_(self.conv.bias)
        if self.coral:
            self.coral_bias = nn.Parameter(torch.tensor([1.0, 0.0, -1.0]))

    def forward(self, x, train: bool = False) -> torch.Tensor:
        if not self.packed:
            return self._fine(x, train)
        x, fold = consume_fold(x)
        out = self.conv(x, fold=fold)
        if train:
            b, h, w, pn = out.shape
            out = out.reshape(b, h, 4 * w, pn // 4)
        else:
            out = depth_to_space(out)
        if self.coral:
            out = out + self.coral_bias.to(out.dtype)
        return out

    def _fine(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.coral:
            out = conv_nhwc(x.to(self.dtype), self.conv.weight)
            out = out + self.coral_bias.to(out.dtype)
        else:
            out = conv_bias_nhwc(x, self.conv, self.dtype)
        if self.interpolate:
            size = 512 if train else 1024
            out = interpolate_bilinear(out, (size, size))
        return out
