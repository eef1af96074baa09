"""LTE texture encoders, NCHW (crfp_tpu/nn/lte.py:21-40)."""

from __future__ import annotations

import torch
from torch import nn

from crfp_torch.nn.layers import Conv, lrelu


class LTESimpleLR(nn.Module):
    """Two 3x3 convs + lrelu over the LR frame (3 channels in)."""

    def __init__(self, mid_channels: int, in_channels: int = 3):
        super().__init__()
        self.slice1_conv1 = Conv(in_channels, mid_channels)
        self.slice1_conv2 = Conv(mid_channels, mid_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lrelu(self.slice1_conv2(lrelu(self.slice1_conv1(x))))


class LTESimpleHRSingle(LTESimpleLR):
    """The same over the 6-channel HR input (the runtime model feeds it
    ``concat([fv, fv])``)."""

    def __init__(self, mid_channels: int, in_channels: int = 6):
        super().__init__(mid_channels, in_channels)
