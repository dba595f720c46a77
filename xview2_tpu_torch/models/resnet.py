"""ResNet-50/101/152 encoder backbones (port of
``xview2_tpu/models/resnet.py``).

torchvision Bottleneck semantics, including ``replace_stride_with_dilation``
rewiring as the reference wires it (``[False, dilation == 4, dilation in
[2, 4]]``).  Module names follow the flax tree (``conv1``, ``bn1``, ...,
``downsample_conv``, ``downsample_bn``; stages ``block0..``), tensors are
NHWC and the convolutions are library calls on channels-last views (the 1x1
ones through ``layers.conv1x1``: matrix products under ``--einsum_1x1``).  On a
band of rows (``--spatial_shards``) the convolutions and the stem's max pool
read their halo rows from the neighbours (``layers.conv_nhwc``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from xview2_tpu_torch.models.layers import (BatchNorm, bn_act, bn_add_relu, conv1x1, conv_nhwc,
                                            halo_extent)
from xview2_tpu_torch.parallel import mesh

RESNET_LAYERS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=False)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride, dilation) -> 1x1(x4) + skip."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dilation, self.dtype = stride, dilation, dtype
        out = planes * self.expansion
        self.conv1 = _conv(in_planes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = BatchNorm(out)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(in_planes, out, 1)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        dt = self.dtype
        out = bn_act(self.bn1, conv1x1(x, self.conv1.weight), train, "relu", dt, remat_tail=True)
        out = conv_nhwc(out, self.conv2.weight, stride=self.stride, padding=self.dilation,
                        dilation=self.dilation)
        out = bn_act(self.bn2, out, train, "relu", dt, remat_tail=True)
        out = conv1x1(out, self.conv3.weight)
        identity = x
        if self.downsample:
            identity = conv1x1(x, self.downsample_conv.weight, stride=self.stride)
            identity = bn_act(self.downsample_bn, identity, train, "none", dt, remat_tail=True)
        return bn_add_relu(self.bn3, out, identity, train, dt, remat_tail=True)


class ResNetStage(nn.Module):
    """One torchvision ``layerN``: the first block may stride/downsample."""

    def __init__(self, in_planes: int, planes: int, num_blocks: int, stride: int = 1,
                 first_dilation: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * Bottleneck.expansion
        self.num_blocks = num_blocks
        self.block0 = Bottleneck(in_planes, planes, stride, first_dilation,
                                 downsample=in_planes != out or stride != 1, dtype=dtype)
        for i in range(1, num_blocks):
            setattr(self, f"block{i}", Bottleneck(out, planes, 1, dilation, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, train)
        return x


class ResNetStem(nn.Module):
    """7x7/2 conv + BN + ReLU (stage 1 in the reference slicing)."""

    def __init__(self, in_channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, 64, 7, bias=False)
        self.bn1 = BatchNorm(64)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv_nhwc(x.to(self.dtype), self.conv1.weight, stride=2, padding=3)
        return bn_act(self.bn1, x, train, "relu", self.dtype, remat_tail=True)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel=3, stride=2, padding=1) on NHWC; on a band of
    rows the row above comes from the neighbour, ``-inf`` at the image's
    top as torch's padding is."""
    if mesh.space_shards() > 1:
        x = mesh.halo_rows(x, *halo_extent(3, 2, 1), fill=-torch.inf)
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                            padding=(0, 1)).permute(0, 2, 3, 1)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)


def resnet_stage_plan(arch: str, dilation: int) -> List[dict]:
    """Stage hyperparameters for layer1..4 after dilation rewiring (torchvision
    ``_make_layer`` with ``replace_stride_with_dilation=[False, dilation==4,
    dilation in (2, 4)]``)."""
    layers = RESNET_LAYERS[arch]
    replace = [False, dilation == 4, dilation in (2, 4)]
    plans = []
    current_dilation = 1
    strides = [1, 2, 2, 2]
    for i, (blocks, stride) in enumerate(zip(layers, strides)):
        dilate = False if i == 0 else replace[i - 1]
        prev = current_dilation
        if dilate:
            current_dilation *= stride
            stride = 1
        plans.append(dict(planes=64 * (2 ** i), num_blocks=blocks, stride=stride,
                          first_dilation=prev, dilation=current_dilation))
    return plans
