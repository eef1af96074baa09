"""Plain building blocks of the reference, NCHW: convs, residual blocks,
pixel-shuffle packs, the FNet flow net, the LTE encoders and the
flow-guided deformable alignment block.

Module and parameter names are those of the benchmarked model's state
dict, so one set of seeded weights loads strictly into both
(``benchmark/reference/names.py``). :func:`quantized` makes every conv
round its input and weight through a caller's function: the lower-precision
control of a cell's comparison.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.ops import lrelu

_QUANT: contextvars.ContextVar = contextvars.ContextVar("bench_reference_quant", default=None)


@contextlib.contextmanager
def quantized(fn):
    """Inside the block every conv computes on ``fn(input)`` and
    ``fn(weight)``, and the served frame is stored through ``fn``."""
    token = _QUANT.set(fn)
    try:
        yield
    finally:
        _QUANT.reset(token)


def rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` through the function of :func:`quantized`, where one is set (an
    output the model stores, such as the served frame)."""
    q = _QUANT.get()
    return x if q is None else q(x)


class Conv(nn.Module):
    """k x k conv, 'same' padding, holding an ``nn.Conv2d`` named ``conv``;
    ``kind`` names the weight recipe of ``benchmark/reference/names.py``."""

    def __init__(self, cin: int, cout: int, k: int = 3, kind: str = "plain"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, device="meta")
        self.kind = kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = _QUANT.get()
        if q is None:
            return self.conv(x)
        return F.conv2d(q(x), q(self.conv.weight), self.conv.bias, padding=self.conv.padding)


class ResidualBlockNoBN(nn.Module):
    def __init__(self, m: int):
        super().__init__()
        self.conv1 = Conv(m, m, kind="residual")
        self.conv2 = Conv(m, m, kind="residual")

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class ResidualBlocksWithInputConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.input_conv = Conv(cin, cout)
        self.block0 = ResidualBlockNoBN(cout)

    def forward(self, x):
        return self.block0(lrelu(self.input_conv(x)))


class ResidualBlocksWithInputConvV2(nn.Module):
    """Two input convs: ``conv1`` on the ROI, ``conv2`` on the full frame,
    the ROI result patched into the top-left corner of the full one. With
    the ROI as large as the frame only ``conv1`` runs."""

    def __init__(self, roi_ch: int, full_ch: int | None, cout: int):
        super().__init__()
        self.conv1 = Conv(roi_ch, cout)
        if full_ch is not None:
            self.conv2 = Conv(full_ch, cout)
        self.block0 = ResidualBlockNoBN(cout)

    def forward(self, roi, full=None):
        o1 = self.conv1(roi)
        if full is not None and full.shape[-2:] != roi.shape[-2:]:
            x = self.conv2(full).clone()
            x[:, :, : o1.shape[2], : o1.shape[3]] = o1
        else:
            x = o1
        return self.block0(lrelu(x))


class PixelShufflePack(nn.Module):
    def __init__(self, cin: int, cout: int, s: int):
        super().__init__()
        self.s = s
        self.upsample_conv = Conv(cin, cout * s * s, kind="shuffle")

    def forward(self, x):
        return F.pixel_shuffle(self.upsample_conv(x), self.s)


class PixelUnShufflePackV2(nn.Module):
    def __init__(self, cin: int, cout: int, s: int):
        super().__init__()
        self.s = s
        self.downsample_conv = Conv(cin * s * s, cout, kind="shuffle")

    def forward(self, x):
        return self.downsample_conv(F.pixel_unshuffle(x, self.s))


class FNet(nn.Module):
    """Flow from x1 to x2 (N, 3, H, W): three conv-conv-avgpool stages, three
    conv-conv-bilinear-x2 stages, two flow convs, ``tanh * 256``, resized
    back to the input size; (N, 2, H, W) as (dx, dy) in pixels."""

    _ENC = (32, 64, 128)
    _DEC = (256, 128, 64)

    def __init__(self, img: int = 3):
        super().__init__()
        cin = 2 * img
        for i, ch in enumerate(self._ENC):
            self.add_module(f"encoder{i + 1}_conv1", Conv(cin, ch))
            self.add_module(f"encoder{i + 1}_conv2", Conv(ch, ch))
            cin = ch
        for i, ch in enumerate(self._DEC):
            self.add_module(f"decoder{i + 1}_conv1", Conv(cin, ch))
            self.add_module(f"decoder{i + 1}_conv2", Conv(ch, ch))
            cin = ch
        self.flow_conv1 = Conv(cin, 32)
        self.flow_conv2 = Conv(32, 2, kind="flow_head")

    def forward(self, x1, x2):
        h, w = x1.shape[-2:]
        out = torch.cat([x1, x2], dim=1)
        for i in range(3):
            out = F.relu(getattr(self, f"encoder{i + 1}_conv1")(out))
            out = F.relu(getattr(self, f"encoder{i + 1}_conv2")(out))
            out = ops.avg_pool_2x(out)
        for i in range(3):
            out = F.relu(getattr(self, f"decoder{i + 1}_conv1")(out))
            out = F.relu(getattr(self, f"decoder{i + 1}_conv2")(out))
            out = ops.upsample(out, 2)
        out = F.relu(self.flow_conv1(out))
        out = torch.tanh(self.flow_conv2(out)) * 256.0
        return ops.resize_bilinear(out, (h, w))


class LTE(nn.Module):
    """Two 3x3 convs + lrelu (the LR encoder, and the HR one over the
    6-channel fovea input)."""

    def __init__(self, m: int, cin: int):
        super().__init__()
        self.slice1_conv1 = Conv(cin, m)
        self.slice1_conv2 = Conv(m, m)

    def forward(self, x):
        return lrelu(self.slice1_conv2(lrelu(self.slice1_conv1(x))))


class DCNAlign(nn.Module):
    """concat(cur, warped previous, flow) -> two conv + lrelu -> [fuse the
    previous stage's offset feature] -> offset ``mag * tanh(raw) + flow``
    (flipped to (dy, dx)) and sigmoid mask heads -> the modulated DCN.
    ``repeat``: one offset and one mask a pixel for all taps (G = 1).
    ``grid``: a callable giving the anchored cell grid for x's shape, or
    None for the ``±window`` clamp. ``fused``: the program computes this
    stage's offsets inside its kernel when nothing records gradients (for
    the byte count only)."""

    def __init__(self, m: int, g: int, k: int = 3, mag: float = 10.0, *, repeat: bool = False,
                 pre_offset: bool = False, pixelshuffle: bool = False,
                 window: int | None = None, pre_offset_channels: int | None = None,
                 grid=None, fused: bool = False):
        super().__init__()
        self.g, self.mag = g, mag
        self.repeat, self.window, self.grid, self.fused = repeat, window, grid, fused
        self.pixelshuffle = pixelshuffle
        self.dcn_block_conv1 = Conv(2 * m + 2, m)
        self.dcn_block_conv2 = Conv(m, m)
        if pre_offset:
            if pixelshuffle:
                self.upsample = PixelShufflePack(pre_offset_channels or m, m, 4)
            self.conv_fuse = Conv(2 * m, m)
        t = 1 if repeat else k * k
        self.dcn_offset = Conv(m, g * 2 * t, kind="offset_head")
        self.dcn_mask = Conv(m, g * t, kind="mask_head")
        self.dcn_weight = nn.Parameter(torch.empty(m, m, k, k, device="meta"))
        self.dcn_bias = nn.Parameter(torch.empty(m, device="meta"))

    def forward(self, cur_x, pre_x, pre_x_aligned, flow, pre_offset_feat=None):
        feat = torch.cat([cur_x, pre_x_aligned, flow.to(cur_x.dtype)], dim=1)
        feat = lrelu(self.dcn_block_conv1(feat))
        feat = lrelu(self.dcn_block_conv2(feat))
        if pre_offset_feat is not None:
            if self.pixelshuffle:
                pre_offset_feat = self.upsample(pre_offset_feat) * 2.0
            feat = lrelu(self.conv_fuse(torch.cat([feat, pre_offset_feat], dim=1)))
        n, _, h, w = feat.shape
        g, mag = self.g, self.mag
        flow = flow.float()
        raw = self.dcn_offset(feat).float()
        if self.repeat:
            off_y = mag * torch.tanh(raw[:, :g]) + flow[:, 1:2]
            off_x = mag * torch.tanh(raw[:, g:]) + flow[:, 0:1]
        else:
            raw = raw.reshape(n, -1, 2, h, w)
            off_y = mag * torch.tanh(raw[:, :, 0]) + flow[:, 1:2]
            off_x = mag * torch.tanh(raw[:, :, 1]) + flow[:, 0:1]
        off = torch.stack([off_y, off_x], dim=2).reshape(n, -1, h, w)
        mask = torch.sigmoid(self.dcn_mask(feat).float())
        q = _QUANT.get()
        x = pre_x if q is None else q(pre_x)
        grid = None if self.grid is None or self.window is None else self.grid(x)
        aligned = ops.deform_conv2d(x, off, mask, self.dcn_weight.float(), self.dcn_bias.float(),
                                    window=self.window, shared=self.repeat, anchor=grid,
                                    fused=self.fused and not torch.is_grad_enabled())
        return aligned, feat
