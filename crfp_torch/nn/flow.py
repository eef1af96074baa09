"""Optical-flow nets, NCHW (crfp_tpu/nn/flow.py).

- ``FNet`` (:26-49): TecoGAN/EGVSR-style encoder-decoder: three
  conv-conv-avgpool stages, three conv-conv-bilinear-x2 stages, two flow
  convs, ``tanh * 256``, and a final bilinear resize back to the input size.
- ``SPyNet`` (:52-100): 6-level coarse-to-fine residual flow over an
  average-pool pyramid of ImageNet-normalised frames, bilinearly resized up
  to a multiple of 32; each level warps the support frame with border
  padding. Plain PyTorch: its warp has no kernel on either chip.

Both return flow (N, 2, H, W) with channels (dx, dy) in pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from crfp_torch.nn.layers import Conv
from crfp_torch.ops.resize import avg_pool_2x, resize_bilinear, upsample
from crfp_torch.ops.warp import flow_warp


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


class SPyNetBasicModule(nn.Module):
    """Five 7x7 convs 8 -> 32 -> 64 -> 32 -> 16 -> 2, each after a ReLU."""

    _CH = (32, 64, 32, 16, 2)

    def __init__(self):
        super().__init__()
        cin = 8
        for i, ch in enumerate(self._CH):
            self.add_module(f"conv{i}", Conv(cin, ch, 7))
            cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self._CH)):
            x = getattr(self, f"conv{i}")(F.relu(x))
        return x


_SPYNET_MEAN = (0.485, 0.456, 0.406)
_SPYNET_STD = (0.229, 0.224, 0.225)
_CONSTANTS: dict = {}


def _constant(values: tuple, like: torch.Tensor) -> torch.Tensor:
    """``values`` as a 1-d tensor in ``like``'s dtype on its device, made once
    per (values, dtype, device): a tensor made from host data on a card copies
    and then waits for everything queued before it, which would stall the
    host at every call. Made outside inference mode, so that autograd may
    use it after a call under ``torch.inference_mode()``."""
    key = (values, like.dtype, like.device)
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = torch.tensor(values, dtype=like.dtype, device=like.device)
    return t


class SPyNet(nn.Module):
    """Flow from ``ref`` to ``supp``; both (N, 3, H, W), any H and W."""

    def __init__(self, levels: int = 6):
        super().__init__()
        self.levels = levels
        for level in range(levels):
            self.add_module(f"basic_module{level}", SPyNetBasicModule())

    def forward(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        n, _, h, w = ref.shape
        h_up = h if h % 32 == 0 else 32 * (h // 32 + 1)
        w_up = w if w % 32 == 0 else 32 * (w // 32 + 1)
        mean = _constant(_SPYNET_MEAN, ref).view(1, 3, 1, 1)
        std = _constant(_SPYNET_STD, ref).view(1, 3, 1, 1)
        refs = [(resize_bilinear(ref, (h_up, w_up)) - mean) / std]
        supps = [(resize_bilinear(supp, (h_up, w_up)) - mean) / std]
        for _ in range(self.levels - 1):
            refs.append(avg_pool_2x(refs[-1]))
            supps.append(avg_pool_2x(supps[-1]))
        refs, supps = refs[::-1], supps[::-1]

        flow = ref.new_zeros(n, 2, h_up // 32, w_up // 32)
        for level in range(self.levels):
            if level == 0:
                flow_up = flow
            else:
                flow_up = resize_bilinear(flow, tuple(refs[level].shape[-2:]),
                                          align_corners=True) * 2.0
            warped = flow_warp(supps[level], flow_up, padding_mode="border")
            inp = torch.cat([refs[level], warped, flow_up], dim=1)
            flow = flow_up + getattr(self, f"basic_module{level}")(inp)

        flow = resize_bilinear(flow, (h, w))
        return flow * _constant((w / w_up, h / h_up), ref).view(1, 2, 1, 1)
