"""LTE texture encoders, NCHW (crfp_tpu/nn/lte.py).

- ``LTESimpleLR`` / ``LTESimpleHRSingle``: two 3x3 convs + lrelu (:21-40).
- ``LTESimpleHR``: the 3-level pyramid of ``basic_fvsr`` with 2x2 max
  pooling (:43-65); flax's ``nn.max_pool`` pads VALID, which is
  ``F.max_pool2d(x, 2, 2)``.
- ``LTESimpleHRPS``: the 4-level pyramid of ``v18_cra`` through
  ``pixel_unshuffle(4)`` (:108-130).
- ``LTESimpleHRV1``: the 3-level pyramid widening mid/4 -> mid/2 -> mid
  (:68-88), and ``LTESimpleHRX8``: four max-pooled levels of 64 channels
  whose ``conv_lv`` names run in reverse (:91-105). No shipped model uses
  either; the JAX package defines both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from crfp_torch.nn.layers import Conv, lrelu
from crfp_torch.ops.shuffle import pixel_unshuffle


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


def _lrelu_convs(x: torch.Tensor, *convs: nn.Module) -> torch.Tensor:
    for conv in convs:
        x = lrelu(conv(x))
    return x


class LTESimpleHR(nn.Module):
    """``forward(x)`` -> (x_lv1, x_lv2, x_lv3): ``mid`` channels each, at 1/4,
    1/2 and full size of x. ``forward_lv1`` computes x_lv1 alone: what
    ``basic_fvsr`` reads (crfp_tpu/models/crfp.py:273, where XLA drops the
    other two levels under jit); it skips ``conv_lv3``, a mid-channel conv
    at the full 8x size. The input is the 6-channel HR frame pair."""

    def __init__(self, mid_channels: int):
        super().__init__()
        m = mid_channels
        self.slice1_conv1 = Conv(6, m)
        self.slice1_conv2 = Conv(m, m)
        self.conv_lv3 = Conv(m, m)
        self.slice2_conv1 = Conv(m, m)
        self.slice2_conv2 = Conv(m, m)
        self.conv_lv2 = Conv(m, m)
        self.slice3_conv1 = Conv(m, m)
        self.slice3_conv2 = Conv(m, m)
        self.conv_lv1 = Conv(m, m)

    def forward(self, x: torch.Tensor):
        x = _lrelu_convs(x, self.slice1_conv1, self.slice1_conv2)
        x_lv3 = lrelu(self.conv_lv3(x))
        x = _lrelu_convs(F.max_pool2d(x, 2, 2), self.slice2_conv1, self.slice2_conv2)
        x_lv2 = lrelu(self.conv_lv2(x))
        x = _lrelu_convs(F.max_pool2d(x, 2, 2), self.slice3_conv1, self.slice3_conv2)
        return lrelu(self.conv_lv1(x)), x_lv2, x_lv3

    def forward_lv1(self, x: torch.Tensor) -> torch.Tensor:
        x = _lrelu_convs(x, self.slice1_conv1, self.slice1_conv2)
        x = _lrelu_convs(F.max_pool2d(x, 2, 2), self.slice2_conv1, self.slice2_conv2)
        x = _lrelu_convs(F.max_pool2d(x, 2, 2), self.slice3_conv1, self.slice3_conv2)
        return lrelu(self.conv_lv1(x))


class LTESimpleHRPS(nn.Module):
    """``forward(x)`` -> (x_lv0, x_lv1, x_lv2, x_lv3): x_lv3 at the size of x
    with ``mid`` channels, x_lv0..2 at 1/4 of it with 4*mid. The input is
    the 6-channel HR frame pair."""

    def __init__(self, mid_channels: int):
        super().__init__()
        m, m4 = mid_channels, 4 * mid_channels
        self.slice1_conv1 = Conv(6, m)
        self.slice1_conv2 = Conv(m, m)
        self.conv_lv3 = Conv(m, m)
        self.slice2_conv1 = Conv(16 * m, m4)
        self.slice2_conv2 = Conv(m4, m4)
        self.conv_lv2 = Conv(m4, m4)
        self.slice3_conv1 = Conv(m4, m4)
        self.slice3_conv2 = Conv(m4, m4)
        self.conv_lv1 = Conv(m4, m4)
        self.slice4_conv1 = Conv(m4, m4)
        self.slice4_conv2 = Conv(m4, m4)
        self.conv_lv0 = Conv(m4, m4)

    def forward(self, x: torch.Tensor):
        x = _lrelu_convs(x, self.slice1_conv1, self.slice1_conv2)
        x_lv3 = lrelu(self.conv_lv3(x))
        x = _lrelu_convs(pixel_unshuffle(x, 4), self.slice2_conv1, self.slice2_conv2)
        x_lv2 = lrelu(self.conv_lv2(x))
        x = _lrelu_convs(x, self.slice3_conv1, self.slice3_conv2)
        x_lv1 = lrelu(self.conv_lv1(x))
        x = _lrelu_convs(x, self.slice4_conv1, self.slice4_conv2)
        return lrelu(self.conv_lv0(x)), x_lv1, x_lv2, x_lv3


class LTESimpleHRV1(nn.Module):
    """``forward(x)`` -> (x_lv1, x_lv2, x_lv3) with mid, mid/2 and mid/4
    channels at 1/4, 1/2 and full size of x. The input is the 6-channel
    HR frame pair."""

    def __init__(self, mid_channels: int):
        super().__init__()
        m1, m2, m = mid_channels // 4, mid_channels // 2, mid_channels
        self.slice1_conv1 = Conv(6, m1)
        self.slice1_conv2 = Conv(m1, m1)
        self.conv_lv3 = Conv(m1, m1)
        self.slice2_conv1 = Conv(m1, m2)
        self.slice2_conv2 = Conv(m2, m2)
        self.conv_lv2 = Conv(m2, m2)
        self.slice3_conv1 = Conv(m2, m)
        self.slice3_conv2 = Conv(m, m)
        self.conv_lv1 = Conv(m, m)

    def forward(self, x: torch.Tensor):
        x = _lrelu_convs(x, self.slice1_conv1, self.slice1_conv2)
        x_lv3 = lrelu(self.conv_lv3(x))
        x = _lrelu_convs(F.max_pool2d(x, 2, 2), self.slice2_conv1, self.slice2_conv2)
        x_lv2 = lrelu(self.conv_lv2(x))
        x = _lrelu_convs(F.max_pool2d(x, 2, 2), self.slice3_conv1, self.slice3_conv2)
        return lrelu(self.conv_lv1(x)), x_lv2, x_lv3


class LTESimpleHRX8(nn.Module):
    """``forward(x)`` -> (x_lv0, x_lv1, x_lv2, x_lv3), 64 channels each, at
    1/8, 1/4, 1/2 and full size of x; level ``k`` of the loop (k max pools
    in) ends in ``conv_lv{3-k}``. The input is the 6-channel HR frame
    pair."""

    def __init__(self):
        super().__init__()
        cin = 6
        for level in range(4):
            self.add_module(f"slice{level + 1}_conv1", Conv(cin, 64))
            self.add_module(f"slice{level + 1}_conv2", Conv(64, 64))
            self.add_module(f"conv_lv{3 - level}", Conv(64, 64))
            cin = 64

    def forward(self, x: torch.Tensor):
        outs = []
        for level in range(4):
            if level > 0:
                x = F.max_pool2d(x, 2, 2)
            x = _lrelu_convs(x, getattr(self, f"slice{level + 1}_conv1"),
                             getattr(self, f"slice{level + 1}_conv2"))
            outs.append(lrelu(getattr(self, f"conv_lv{3 - level}")(x)))
        x_lv3, x_lv2, x_lv1, x_lv0 = outs
        return x_lv0, x_lv1, x_lv2, x_lv3
