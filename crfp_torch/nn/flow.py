"""FNet optical flow, NCHW (crfp_tpu/nn/flow.py:26-49).

TecoGAN/EGVSR-style encoder-decoder: three conv-conv-avgpool stages, three
conv-conv-bilinear-x2 stages, two flow convs, ``tanh * 256``, and a final
bilinear resize back to the input size. Returns flow (N, 2, H, W) with
channels (dx, dy) in pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from crfp_torch.nn.layers import Conv
from crfp_torch.ops.resize import avg_pool_2x, resize_bilinear, upsample


class FNet(nn.Module):
    """Flow from x1 to x2; both (N, img_channels, H, W)."""

    _ENC = (32, 64, 128)
    _DEC = (256, 128, 64)

    def __init__(self, img_channels: int = 3):
        super().__init__()
        cin = 2 * img_channels
        for i, ch in enumerate(self._ENC):
            self.add_module(f"encoder{i + 1}_conv1", Conv(cin, ch))
            self.add_module(f"encoder{i + 1}_conv2", Conv(ch, ch))
            cin = ch
        for i, ch in enumerate(self._DEC):
            self.add_module(f"decoder{i + 1}_conv1", Conv(cin, ch))
            self.add_module(f"decoder{i + 1}_conv2", Conv(ch, ch))
            cin = ch
        self.flow_conv1 = Conv(cin, 32)
        self.flow_conv2 = Conv(32, 2)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        h, w = x1.shape[-2:]
        if min(h, w) < 8:
            raise ValueError(f"FNet needs frames of at least 8x8 pixels (its "
                             f"encoder pools 3 times); got {h}x{w}")
        out = torch.cat([x1, x2], dim=1)
        for i in range(len(self._ENC)):
            out = F.relu(getattr(self, f"encoder{i + 1}_conv1")(out))
            out = F.relu(getattr(self, f"encoder{i + 1}_conv2")(out))
            out = avg_pool_2x(out)
        for i in range(len(self._DEC)):
            out = F.relu(getattr(self, f"decoder{i + 1}_conv1")(out))
            out = F.relu(getattr(self, f"decoder{i + 1}_conv2")(out))
            out = upsample(out, 2)
        out = F.relu(self.flow_conv1(out))
        out = torch.tanh(self.flow_conv2(out)) * 256.0
        return resize_bilinear(out, (h, w))
