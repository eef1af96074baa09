"""The plain v18 streaming model: ``encode``, ``step0`` on a stream's first
frame, ``step`` on every later one, NCHW.

v18 with mid channels ``m`` keeps per-level states at a quarter of the HR
size beside an HR state of ``m / 8`` channels. A steady frame: the flow of
the current LR frame to the previous one on the ROI's crop, the HR state
warped by it (clamped to ``±window_hr``, or per-cell anchored windows),
three quarter-size deformable alignment stages (per-tap, ``dg`` groups,
``±window``) and the HR one (one offset a pixel for all taps, anchored or
``±window_hr``), the fovea blended into the top-left corner, and the frame
``conv_last(hr feature) + bilinear x8 of the LR frame``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from benchmark.reference import ops
from benchmark.reference.nets import (
    LTE,
    Conv,
    DCNAlign,
    FNet,
    PixelShufflePack,
    PixelUnShufflePackV2,
    ResidualBlocksWithInputConv,
    ResidualBlocksWithInputConvV2,
    rounded,
)
from benchmark.reference.ops import lrelu


@dataclass(frozen=True)
class Spec:
    """What the reference needs of a configuration: the widths, the windows
    (None: exact), anchoring and the activations' precision that sets its
    cell grid (``grid_bf16``), the HR warp's cell grid (``s2d`` 4: the
    s2d(4) tail's), whether the program fuses the quarter-size stages'
    offsets into one kernel (``fused``), and the batch trunk's training
    grid (``fullgrad``)."""

    mid: int = 32
    dg: int = 8
    k: int = 3
    mag: float = 10.0
    scale: int = 8
    split: int = 3
    window: int | None = None
    window_hr: int | None = None
    anchor: bool = False
    grid_bf16: bool = False
    s2d: int = 1
    fused: bool = False
    fullgrad: bool = False

    @property
    def last(self) -> int:
        return self.mid // 8

    @property
    def keep(self) -> int:
        return self.mid * self.split // 4


def hr_dcn_grid(spec: Spec):
    """The anchored grid of the HR DCN stage, or None."""
    if not spec.anchor or spec.window_hr is None:
        return None
    c = spec.last
    return lambda x: ops.dcn_anchor_grid(c, c, 1, spec.k, spec.window_hr, bf16=spec.grid_bf16,
                                         shared=True, fullgrad=spec.fullgrad)


def hr_warp(spec: Spec, state: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The HR state warp: anchored or clamped to ``±window_hr``."""
    grid = None
    if spec.anchor and spec.window_hr is not None:
        grid = ops.warp_anchor_grid(state.shape[1], spec.window_hr, bf16=spec.grid_bf16,
                                    s2d=spec.s2d, fullgrad=spec.fullgrad)
    return ops.flow_warp(state, flow, spec.window_hr, anchor=grid)


def build_alignment(module: nn.Module, spec: Spec) -> None:
    m, dg, k, mag = spec.mid, spec.dg, spec.k, spec.mag
    lv = dict(window=spec.window, fused=spec.fused)
    module.dcn_0 = DCNAlign(m, dg, k, mag, **lv)
    module.dcn_1 = DCNAlign(m, dg, k, mag, pre_offset=True, **lv)
    module.dcn_2 = DCNAlign(m, dg, k, mag, pre_offset=True, **lv)
    module.dcn_3 = DCNAlign(spec.last, 1, k, mag, repeat=True, pre_offset=True,
                            pixelshuffle=True, window=spec.window_hr, pre_offset_channels=m,
                            grid=hr_dcn_grid(spec))


class RuntimeV18(nn.Module):
    """The streaming model over a ``warp`` (height, width) region of interest
    at the top-left of the HR frame."""

    def __init__(self, spec: Spec, warp: tuple[int, int]):
        super().__init__()
        self.spec, self.warp = spec, tuple(warp)
        m, last, keep = spec.mid, spec.last, spec.keep
        self.spynet = FNet(3)
        build_alignment(self, spec)
        self.encoder_lr = LTE(m, 3)
        self.encoder_hr = LTE(last, 6)
        self.conv_tttf = Conv(2 * last, last)
        self.conv_last = Conv(last, 3)
        for i in range(3):
            self.add_module(f"forward_resblocks_{i}_", ResidualBlocksWithInputConv(keep, m))
        self.forward_resblocks_3_ = ResidualBlocksWithInputConv(last, last)
        for i in range(3):
            self.add_module(f"forward_resblocks_{i}",
                            ResidualBlocksWithInputConvV2(2 * m, None, m))
        self.forward_resblocks_3 = ResidualBlocksWithInputConvV2(2 * last, last, last)
        self.downsample = PixelUnShufflePackV2(last, m, 4)
        self.upsample = PixelShufflePack(m, keep, 2)
        self.upsample_post = PixelShufflePack(keep, last, 4)

    def encode(self, lr, fv):
        return self.encoder_lr(lr), self.encoder_hr(torch.cat([fv, fv], dim=1))

    def _finish(self, lv3, x_hr, lr):
        fh, fw = x_hr.shape[-2:]
        blended = self.conv_tttf(torch.cat([lv3[:, :, :fh, :fw], x_hr], dim=1))
        lv3 = torch.cat([torch.cat([blended, lv3[:, :, :fh, fw:]], dim=3), lv3[:, :, fh:]], dim=2)
        lv3 = lrelu(lv3)
        return lv3, rounded(ops.emit_frame(self.conv_last(lv3), lr))

    def step0(self, lr, x_lr, x_hr):
        sr = self.spec.split
        wh, ww = self.warp
        x = self.upsample(x_lr)
        lvs = []
        for i in range(3):
            chunks = torch.chunk(getattr(self, f"forward_resblocks_{i}_")(x), 4, dim=1)
            lvs.append(torch.cat(chunks[sr:], dim=1)[:, :, : wh // 4, : ww // 4])
            x = torch.cat(chunks[:sr], dim=1)
        x = lrelu(self.upsample_post(x))
        lv3, out = self._finish(self.forward_resblocks_3_(x), x_hr, lr)
        return {"hr": lv3[:, :, :wh, :ww], "lv": tuple(lvs)}, out

    def step(self, state, lr, pre_lr, x_lr, x_hr):
        spec = self.spec
        sr = spec.split
        wh, ww = self.warp
        flow = self.spynet(lr[:, :, : wh // 8, : ww // 8], pre_lr[:, :, : wh // 8, : ww // 8])
        feat_lv0 = self.upsample(x_lr)
        flow_lv3 = (ops.upsample(flow, 2) * 2.0).float()
        flow_lv0 = (ops.upsample(flow, spec.scale) * float(spec.scale)).float()
        hr_state = state["hr"]
        hr_warped = hr_warp(spec, hr_state, flow_lv0)
        lv3_warped = self.downsample(hr_warped)
        lv3_state = self.downsample(hr_state)
        feats = torch.chunk(ops.flow_warp(torch.cat(state["lv"], dim=1), flow_lv3, spec.window),
                            3, dim=1)
        roi_lv0 = feat_lv0[:, :, : wh // 4, : ww // 4]
        offset, lvs = None, []
        for i in range(3):
            feat_temp = torch.cat([roi_lv0, feats[i]], dim=1)
            aligned, offset = getattr(self, f"dcn_{i}")(feat_temp, lv3_state, lv3_warped,
                                                        flow_lv3, offset)
            rb = getattr(self, f"forward_resblocks_{i}")
            chunks = torch.chunk(rb(torch.cat([feat_temp, aligned], dim=1), feat_temp), 4, dim=1)
            lvs.append(torch.cat(chunks[sr:], dim=1))
        full_lv3 = lrelu(self.upsample_post(feat_lv0))
        roi = full_lv3[:, :, :wh, :ww]
        aligned, _ = self.dcn_3(roi, hr_state, hr_warped, flow_lv0, offset)
        lv3 = self.forward_resblocks_3(torch.cat([roi, aligned], dim=1), full_lv3)
        lv3, out = self._finish(lv3, x_hr, lr)
        return {"hr": lv3[:, :, :wh, :ww], "lv": tuple(lvs)}, out
