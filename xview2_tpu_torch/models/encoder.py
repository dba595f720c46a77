"""Encoder factory: 5-stage slicing of the ResNet and ResNeSt backbones
(port of ``xview2_tpu/models/encoder.py``).

stage1 = stem conv(s)+BN+ReLU, stage2 = maxpool + layer1, stage3..5 =
layer2..4, with encoder channels ``[64|128, 256, 512, 1024, 2048]``: a
64-channel stem for resnet* and resnest50, 128 for resnest101/200/269.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from xview2_tpu_torch.models.resnest import (RESNEST_STEM_WIDTH, ResNeStStage, ResNeStStem,
                                             resnest_stage_plan)
from xview2_tpu_torch.models.resnet import (ResNetStage, ResNetStem, max_pool_3x3_s2,
                                            resnet_stage_plan)


def encoder_channels(encoder: str) -> List[int]:
    if encoder.startswith("resnest"):
        return [2 * RESNEST_STEM_WIDTH[encoder], 256, 512, 1024, 2048]
    return [64, 256, 512, 1024, 2048]


class MaxPoolStage(nn.Module):
    """maxpool(3x3, stride 2, pad 1) followed by a residual stage (stage 2)."""

    def __init__(self, stage: nn.Module):
        super().__init__()
        self.stage = stage

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.stage(max_pool_3x3_s2(x), train)


def make_encoder_stages(encoder: str, dilation: int, in_channels: int,
                        dtype: torch.dtype) -> Tuple[List[int], List[nn.Module]]:
    """Build the 5 stage modules and their output channels."""
    chans = encoder_channels(encoder)
    if encoder.startswith("resnest"):
        stem: nn.Module = ResNeStStem(in_channels, RESNEST_STEM_WIDTH[encoder], dtype)
        plans = resnest_stage_plan(encoder, dilation)
        stage_cls = ResNeStStage
    else:
        stem = ResNetStem(in_channels, dtype)
        plans = resnet_stage_plan(encoder, dilation)
        stage_cls = ResNetStage
    in_planes = [chans[0]] + [p["planes"] * 4 for p in plans[:-1]]
    stages = [stage_cls(cin, dtype=dtype, **p) for cin, p in zip(in_planes, plans)]
    return chans, [stem, MaxPoolStage(stages[0]), *stages[1:]]
