"""ResNeSt-50/101/200/269 split-attention encoder backbones (port of
``xview2_tpu/models/resnest.py``).

Radix-2 split-attention bottlenecks, the deep 3-conv stem, average-pool
downsampling in the shortcut (``avg_down``) and the average-pool stride
after the split-attention conv (``avd``), with the encoder ``dilation``
rewiring of ``--dilation``.  Module names follow the flax tree (``conv1``,
``bn1``, ``conv2.conv``, ``conv2.bn0``, ``conv2.fc1``, ...,
``downsample_conv``; the stem's ``conv1a``/``bn1a``/.../``bn1``), tensors
are NHWC and the convolutions are library calls on channels-last views.
On a band of rows (``--spatial_shards``) the convolutions and the avd pool
read their halo rows from the neighbours, and the split attention's global
pool sums over the space group (``parallel/mesh.py``).

===========  ============  ==========  =====
model        layers        stem_width  radix
===========  ============  ==========  =====
resnest50    (3, 4, 6, 3)       32       2
resnest101   (3, 4, 23, 3)      64       2
resnest200   (3, 24, 36, 3)     64       2
resnest269   (3, 30, 48, 8)     64       2
===========  ============  ==========  =====

All with cardinality 1, bottleneck width 64, avg_down and avd after the
conv, so the stem puts out ``2 * stem_width`` channels.  BatchNorm runs as
everywhere in the port: the eval fold from the running statistics
(``layers.norm_act``) or, in train mode, ``BatchNorm.normalize_train``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from xview2_tpu_torch.models.layers import (BatchNorm, bn_act, bn_add_relu, conv1x1, conv_nhwc,
                                            halo_extent)
from xview2_tpu_torch.ops.norm_act import records
from xview2_tpu_torch.parallel import mesh

RESNEST_LAYERS = {
    "resnest50": (3, 4, 6, 3),
    "resnest101": (3, 4, 23, 3),
    "resnest200": (3, 24, 36, 3),
    "resnest269": (3, 30, 48, 8),
}
RESNEST_STEM_WIDTH = {
    "resnest50": 32,
    "resnest101": 64,
    "resnest200": 64,
    "resnest269": 64,
}


def avg_pool_torch(x: torch.Tensor, window: int, stride: int, padding: int = 0,
                   ceil_mode: bool = False, count_include_pad: bool = True) -> torch.Tensor:
    """torch ``AvgPool2d`` on NHWC as the JAX function computes it: window
    sums in float32 (also for a float64 map), divided by ``window**2``
    (``count_include_pad`` without ``ceil_mode``) or else by the number of
    elements of the window inside the input, then cast back to ``x``'s
    dtype.  That is torch's own divisor, except that with ``ceil_mode`` the
    JAX function never counts the padding.

    The pool runs on a contiguous NCHW copy: on a channels-last map, torch's
    CUDA backward of ``avg_pool2d`` with padding is wrong (torch 2.11,
    CUDA 12.8; ``tests/test_torch_cuda.py`` holds the pools against the
    CPU), so the map is laid out NCHW for the call and back to NHWC after
    it, each in the same copy as the cast.  Where autograd records nothing
    (the eval step) the copy back is made in float32 too, where ``to`` would
    return the NCHW view: the eval BatchNorm kernel after the pool takes a
    contiguous NHWC map, on a band of rows as on the whole image.  Under
    autograd a float32 pool returns that view, as the train step always had.

    On a band of rows (``--spatial_shards``) a padded window (the 3x3 avd
    pool, which counts its padding) reads the rows beyond the band from the
    neighbours, zeros at the image's border, and pads only the width: the
    divisor stays ``window**2``.  The avg-down pool (window = stride, no
    padding) needs no halo: a band starts on a multiple of its stride."""
    if mesh.space_shards() > 1 and padding:
        x = mesh.halo_rows(x, *halo_extent(window, stride, padding))
        padding = (0, padding)
    xf = x.permute(0, 3, 1, 2).to(torch.float32, memory_format=torch.contiguous_format)
    out = F.avg_pool2d(xf, window, stride, padding, ceil_mode=ceil_mode,
                       count_include_pad=count_include_pad and not ceil_mode)
    return out.permute(0, 2, 3, 1).to(x.dtype, memory_format=torch.contiguous_format,
                                      copy=not records(x))


def _conv1x1(cin: int, cout: int, bias: bool = False, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, bias=bias, groups=groups)


def _conv1x1_bias(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Conv(use_bias=True)``: the product in x's dtype, then the
    bias added in that dtype (two roundings)."""
    out = conv_nhwc(x, conv.weight, groups=conv.groups)
    return out + conv.bias.to(out.dtype)


class SplAtConv2d(nn.Module):
    """Split-attention conv: a 3x3 conv grouped by ``cardinality * radix``,
    BN, ReLU, the global pool of the radix sum, ``fc1`` (1x1, grouped by
    cardinality), BN, ReLU, ``fc2``, a softmax over the radix axis, and the
    radix splits summed with those weights.

    Radix 2 with cardinality 1 (every preset) takes the JAX fast path's
    numerics: the softmax over two entries is ``sigmoid(a0 - a1)`` in
    float32, cast, and the output is ``y0 * w0 + y1 * (1 - w0)`` in the
    compute dtype.  The grouped conv is one library call either way (the JAX
    fast path computes the same two dense convs over halves of the same
    kernel).

    On a band of rows the global pool sums the band, sums over the space
    group and divides by the image's H*W; ``bn1`` then normalizes pooled
    values that every rank of the group holds (``replicated``)."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1, dilation: int = 1,
                 radix: int = 2, cardinality: int = 1, reduction_factor: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.radix, self.cardinality = channels, radix, cardinality
        self.stride, self.dilation, self.dtype = stride, dilation, dtype
        inter = max(channels * radix // reduction_factor, 32)
        self.conv = nn.Conv2d(in_channels, channels * radix, 3, groups=cardinality * radix,
                              bias=False)
        self.bn0 = BatchNorm(channels * radix)
        self.fc1 = _conv1x1(channels, inter, bias=True, groups=cardinality)
        self.bn1 = BatchNorm(inter)
        self.fc2 = _conv1x1(inter, channels * radix, bias=True, groups=cardinality)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt, ch, r = self.dtype, self.channels, self.radix
        y = conv_nhwc(x.to(dt), self.conv.weight, stride=self.stride, padding=self.dilation,
                      dilation=self.dilation, groups=self.conv.groups)
        y = bn_act(self.bn0, y, train, "relu", dt)
        b, h, w = y.shape[:3]
        if r == 2 and self.cardinality == 1:
            y0, y1 = y[..., :ch], y[..., ch:]
            splits_sum = y0 + y1
        else:  # torch's channel layout is group-major: radix chunks of ``ch``
            splits = y.reshape(b, h, w, r, ch)
            splits_sum = splits.sum(dim=3)
        n = mesh.space_shards()
        if n > 1:
            gap = mesh.space_sum(splits_sum.to(torch.float32).sum(dim=(1, 2), keepdim=True))
            gap = (gap / (h * n * w)).to(dt)
        else:
            gap = splits_sum.to(torch.float32).mean(dim=(1, 2), keepdim=True).to(dt)
        gap = bn_act(self.bn1, _conv1x1_bias(self.fc1, gap), train, "relu", dt,
                     replicated=n > 1)
        atten = _conv1x1_bias(self.fc2, gap).to(torch.float32)
        if r == 2 and self.cardinality == 1:
            w0 = torch.sigmoid(atten[..., :ch] - atten[..., ch:]).to(dt)
            return y0 * w0 + y1 * (1 - w0)
        atten = torch.softmax(atten.reshape(b, 1, 1, r, ch), dim=3).to(dt)
        return (atten * splits).sum(dim=3)


class ResNeStBottleneck(nn.Module):
    """ResNeSt bottleneck: 1x1, split-attention 3x3, avd pool, 1x1 (x4), with
    the avg_down shortcut (pool, then 1x1 conv and BN)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, downsample_pool_stride: int = 1,
                 is_first: bool = False, radix: int = 2, cardinality: int = 1,
                 bottleneck_width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        group_width = int(planes * (bottleneck_width / 64.0)) * cardinality
        self.use_avd = stride > 1 or is_first
        self.stride = stride
        out = planes * self.expansion
        self.conv1 = _conv1x1(in_planes, group_width)
        self.bn1 = BatchNorm(group_width)
        self.conv2 = SplAtConv2d(group_width, group_width, stride=1 if self.use_avd else stride,
                                 dilation=dilation, radix=radix, cardinality=cardinality,
                                 dtype=dtype)
        self.conv3 = _conv1x1(group_width, out)
        self.bn3 = BatchNorm(out)
        self.downsample, self.pool_stride = downsample, downsample_pool_stride
        if downsample:
            self.downsample_conv = _conv1x1(in_planes, out)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        out = bn_act(self.bn1, conv1x1(x.to(dt), self.conv1.weight), train, "relu", dt)
        out = self.conv2(out, train)
        if self.use_avd:
            out = avg_pool_torch(out, 3, self.stride, padding=1)
        out = conv1x1(out, self.conv3.weight)
        identity = x
        if self.downsample:
            if self.pool_stride > 1:
                identity = avg_pool_torch(identity, self.pool_stride, self.pool_stride,
                                          ceil_mode=True, count_include_pad=False)
            identity = conv1x1(identity.to(dt), self.downsample_conv.weight)
            identity = bn_act(self.downsample_bn, identity, train, "none", dt)
        return bn_add_relu(self.bn3, out, identity, train, dt)


class ResNeStStage(nn.Module):
    """One ``layerN`` of ResNeSt (upstream ``_make_layer``): block 0 takes the
    stride and the avg_down shortcut."""

    def __init__(self, in_planes: int, planes: int, num_blocks: int, stride: int = 1,
                 dilation: int = 1, is_first: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        # upstream: block 0 dilates by 1 (stage dilation 1 or 2) or 2 (stage dilation 4)
        self.block0 = ResNeStBottleneck(
            in_planes, planes, stride=stride, dilation=1 if dilation in (1, 2) else 2,
            downsample=True, downsample_pool_stride=stride if dilation == 1 else 1,
            is_first=is_first, dtype=dtype)
        out = planes * ResNeStBottleneck.expansion
        for i in range(1, num_blocks):
            setattr(self, f"block{i}", ResNeStBottleneck(out, planes, dilation=dilation,
                                                         dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, train)
        return x


class ResNeStStem(nn.Module):
    """Deep 3-conv stem, widths sw, sw, 2*sw, each conv with BN and ReLU
    (stage 1 in the reference slicing)."""

    def __init__(self, in_channels: int, stem_width: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        sw = stem_width
        self.conv1a = nn.Conv2d(in_channels, sw, 3, bias=False)
        self.bn1a = BatchNorm(sw)
        self.conv1b = nn.Conv2d(sw, sw, 3, bias=False)
        self.bn1b = BatchNorm(sw)
        self.conv1c = nn.Conv2d(sw, 2 * sw, 3, bias=False)
        self.bn1 = BatchNorm(2 * sw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = bn_act(self.bn1a, conv_nhwc(x.to(dt), self.conv1a.weight, stride=2, padding=1),
                   train, "relu", dt)
        x = bn_act(self.bn1b, conv_nhwc(x, self.conv1b.weight, padding=1), train, "relu", dt)
        return bn_act(self.bn1, conv_nhwc(x, self.conv1c.weight, padding=1), train, "relu", dt)


def resnest_stage_plan(arch: str, dilation: int) -> List[dict]:
    """Stage hyperparameters for layer1..4 after the dilation rewiring:
    dilation 4 -> layer3 (stride 1, dilation 2) and layer4 (stride 1,
    dilation 4); dilation 2 -> layer4 (stride 1, dilation 2); else strides
    (1, 2, 2, 2) at dilation 1."""
    layers = RESNEST_LAYERS[arch]
    strides = {1: (1, 2, 2, 2), 2: (1, 2, 2, 1), 4: (1, 2, 1, 1)}[dilation]
    dilations = {1: (1, 1, 1, 1), 2: (1, 1, 1, 2), 4: (1, 1, 2, 4)}[dilation]
    return [dict(planes=64 * 2 ** i, num_blocks=layers[i], stride=strides[i],
                 dilation=dilations[i], is_first=i > 0) for i in range(4)]
