"""Encoder factory: 5-stage slicing of the ResNet backbones (port of the
ResNet branch of ``xview2_tpu/models/encoder.py``).

stage1 = stem conv+BN+ReLU, stage2 = maxpool + layer1, stage3..5 =
layer2..4, with encoder channels ``[64, 256, 512, 1024, 2048]``.  The
ResNeSt encoders are not ported yet (ROADMAP Queue 1, ResNeSt encoders).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from xview2_tpu_torch.models.resnet import (ResNetStage, ResNetStem, max_pool_3x3_s2,
                                            resnet_stage_plan)


def encoder_channels(encoder: str) -> List[int]:
    if encoder.startswith("resnest"):
        raise NotImplementedError(f"encoder {encoder!r}: the ResNeSt encoders are not ported "
                                  "yet (ROADMAP Queue 1, ResNeSt encoders)")
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
    plans = resnet_stage_plan(encoder, dilation)
    in_planes = [64] + [p["planes"] * 4 for p in plans[:-1]]
    stages = [ResNetStage(cin, dtype=dtype, **p) for cin, p in zip(in_planes, plans)]
    return chans, [ResNetStem(in_channels, dtype), MaxPoolStage(stages[0]), *stages[1:]]
