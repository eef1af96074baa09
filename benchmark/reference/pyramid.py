"""The plain first-generation full pyramid ``MRCF_x8`` (eugenelet/CRFP,
``model/CRFP_runtime.py:1556-2335``) as a streaming model: ``encode``,
``step0`` on a stream's first frame, ``step`` on every later one, NCHW.

Four levels at 1x, 2x, 4x and 8x the LR frame, of ``mid`` channels each;
only the top level's feature ``lv3`` is carried from frame to frame. A
steady frame: SPyNet's flow of the current LR frame to the previous one;
the lower levels' states re-derived from ``lv3`` by cascaded 0.5x bilinear
resizes and the flow by cascaded 2x ones (its magnitudes not rescaled: the
published model's own quirk); at each level, from lv0 up, the level state
warped by its flow (unclamped), an inline DCN (a 3-conv head over
concat(carry-in, warped state, flow), offsets ``mag * tanh(raw) + flow`` per
tap in ``dg`` groups (16, 16, 4, 1 at levels 0-3 for ``dg`` 16), a sigmoid
mask, the modulated DCN of the unwarped level state), the level's
resblocks over concat(carry-in, aligned), and a 2x pixel-shuffle upsample
into the next level; at lv3 the fovea blended in under its full-size mask
(``conv_tttf_lv3``). The frame is ``conv_last_lv3(lrelu(conv_hr_lv3(lv3)))``
plus the LR frame bilinearly upsampled 8x. ``encode`` runs the LR encoder,
the fovea blended over the bilinear base (three cascaded 2x upsamples of
the LR frame) and the three-level LTE HR encoder over concat(blend, base).

Departures from the published model, each forced by the benchmark:

- ``fv`` is one tensor (N, 4, 8h, 8w): the full-size fovea frame and its
  mask as a fourth channel, as the benchmark's family packs them;
- the DCN weight and bias of level ``k`` are named ``align_lv{k}.dcn_weight``
  and ``align_lv{k}.dcn_bias`` (the benchmark's weight recipes,
  ``benchmark/reference/names.py``, go by those suffixes); the family maps
  them to the program's ``dcn_weight_lv{k}`` / ``dcn_bias_lv{k}``;
- the residual blocks' dead second input conv of the published runtime
  file, which no path reads, is left out, and SPyNet's weights are seeded
  as every other weight (its pretrained ``spynet_20210409`` weights are not
  in this repository).

Built from ``benchmark/reference/nets.py`` and ``ops.py``, so that the
lower-precision control (:func:`benchmark.reference.nets.quantized`)
reaches every conv, the DCN's input and the frame, and the operation and
byte counts (``ops.recording``) see the four level warps and the four DCNs.
SPyNet's border warp is not recorded: the program runs it in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.nets import (
    LTE,
    Conv,
    PixelShufflePack,
    ResidualBlockNoBN,
    ResidualBlocksWithInputConv,
    rounded,
)
from benchmark.reference.ops import lrelu

SPYNET_MEAN = (0.485, 0.456, 0.406)
SPYNET_STD = (0.229, 0.224, 0.225)


class SPyNetBasicModule(nn.Module):
    """Five 7x7 convs 8 -> 32 -> 64 -> 32 -> 16 -> 2, each after a ReLU; the
    last one's weights drawn as a flow head's, so that seeded flows stay a
    few LR pixels."""

    CHANNELS = (32, 64, 32, 16, 2)

    def __init__(self):
        super().__init__()
        cin = 8
        for i, ch in enumerate(self.CHANNELS):
            kind = "flow_head" if i == len(self.CHANNELS) - 1 else "plain"
            self.add_module(f"conv{i}", Conv(cin, ch, 7, kind=kind))
            cin = ch

    def forward(self, x):
        for i in range(len(self.CHANNELS)):
            x = getattr(self, f"conv{i}")(F.relu(x))
        return x


def border_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp of ``x`` by ``flow`` (dx, dy) with the sample positions
    clamped into the frame (``grid_sample``'s border padding)."""
    n, c, h, w = x.shape
    gy = torch.arange(h, device=x.device, dtype=torch.float32).view(1, h, 1)
    gx = torch.arange(w, device=x.device, dtype=torch.float32).view(1, 1, w)
    flow = flow.float()
    sy = (gy + flow[:, 1]).clamp(0.0, h - 1)
    sx = (gx + flow[:, 0]).clamp(0.0, w - 1)
    return ops.bilinear_sample_zeros(x, sy, sx).to(x.dtype)


class SPyNet(nn.Module):
    """Flow from ``ref`` to ``supp`` (N, 3, H, W): six levels of residual
    flow over an average-pool pyramid of the ImageNet-normalised frames,
    each resized up to a multiple of 32; (N, 2, H, W) as (dx, dy) in
    pixels."""

    LEVELS = 6

    def __init__(self):
        super().__init__()
        for level in range(self.LEVELS):
            self.add_module(f"basic_module{level}", SPyNetBasicModule())

    def forward(self, ref, supp):
        n, _, h, w = ref.shape
        h_up, w_up = -(-h // 32) * 32, -(-w // 32) * 32
        mean = torch.tensor(SPYNET_MEAN, dtype=ref.dtype, device=ref.device).view(1, 3, 1, 1)
        std = torch.tensor(SPYNET_STD, dtype=ref.dtype, device=ref.device).view(1, 3, 1, 1)
        refs = [(ops.resize_bilinear(ref, (h_up, w_up)) - mean) / std]
        supps = [(ops.resize_bilinear(supp, (h_up, w_up)) - mean) / std]
        for _ in range(self.LEVELS - 1):
            refs.append(ops.avg_pool_2x(refs[-1]))
            supps.append(ops.avg_pool_2x(supps[-1]))
        refs, supps = refs[::-1], supps[::-1]
        flow = ref.new_zeros(n, 2, h_up // 32, w_up // 32)
        for level in range(self.LEVELS):
            if level > 0:
                flow = ops.resize_bilinear(flow, tuple(refs[level].shape[-2:]),
                                           align_corners=True) * 2.0
            warped = border_warp(supps[level], flow)
            flow = flow + getattr(self, f"basic_module{level}")(
                torch.cat([refs[level], warped, flow], dim=1))
        flow = ops.resize_bilinear(flow, (h, w))
        scale = torch.tensor([w / w_up, h / h_up], dtype=ref.dtype, device=ref.device)
        return flow * scale.view(1, 2, 1, 1)


class LTEHR(nn.Module):
    """The three-level LTE HR encoder over the 6-channel (blend, base) input:
    two convs and a level conv at full size, then twice a 2x2 max pool, two
    convs and a level conv; (lv1, lv2, lv3) at 1/4, 1/2 and full size."""

    def __init__(self, m: int):
        super().__init__()
        self.slice1_conv1 = Conv(6, m)
        self.slice1_conv2 = Conv(m, m)
        self.conv_lv3 = Conv(m, m)
        self.slice2_conv1 = Conv(m, m)
        self.slice2_conv2 = Conv(m, m)
        self.conv_lv2 = Conv(m, m)
        self.slice3_conv1 = Conv(m, m)
        self.slice3_conv2 = Conv(m, m)
        self.conv_lv1 = Conv(m, m)

    def forward(self, x):
        outs = []
        for i, lv in ((1, 3), (2, 2), (3, 1)):
            if i > 1:
                x = F.max_pool2d(x, 2, 2)
            x = lrelu(getattr(self, f"slice{i}_conv1")(x))
            x = lrelu(getattr(self, f"slice{i}_conv2")(x))
            outs.append(lrelu(getattr(self, f"conv_lv{lv}")(x)))
        x_lv3, x_lv2, x_lv1 = outs
        return x_lv1, x_lv2, x_lv3


class LevelAlign(nn.Module):
    """One level's inline DCN: ``dcn_pre_lv{k}``, two block convs (each
    followed by lrelu), per-tap offset and mask heads in ``g`` groups, and
    the modulated 3x3 DCN of the unwarped level state."""

    def __init__(self, m: int, g: int, k: int, mag: float):
        super().__init__()
        self.lv, self.g, self.mag = f"lv{k}", g, mag
        self.add_module(f"dcn_pre_lv{k}", Conv(2 * m + 2, m))
        self.add_module(f"dcn_block_lv{k}_conv1", Conv(m, m))
        self.add_module(f"dcn_block_lv{k}_conv2", Conv(m, m))
        self.add_module(f"dcn_offset_lv{k}", Conv(m, g * 18, kind="offset_head"))
        self.add_module(f"dcn_mask_lv{k}", Conv(m, g * 9, kind="mask_head"))
        self.dcn_weight = nn.Parameter(torch.empty(m, m, 3, 3, device="meta"))
        self.dcn_bias = nn.Parameter(torch.empty(m, device="meta"))

    def forward(self, cur, state, warped, flow):
        lv = self.lv
        feat = torch.cat([cur, warped, flow.to(cur.dtype)], dim=1)
        for name in (f"dcn_pre_{lv}", f"dcn_block_{lv}_conv1", f"dcn_block_{lv}_conv2"):
            feat = lrelu(getattr(self, name)(feat))
        n, _, h, w = feat.shape
        flow = flow.float()
        raw = getattr(self, f"dcn_offset_{lv}")(feat).float().reshape(n, -1, 2, h, w)
        off_y = self.mag * torch.tanh(raw[:, :, 0]) + flow[:, 1:2]
        off_x = self.mag * torch.tanh(raw[:, :, 1]) + flow[:, 0:1]
        off = torch.stack([off_y, off_x], dim=2).reshape(n, -1, h, w)
        mask = torch.sigmoid(getattr(self, f"dcn_mask_{lv}")(feat).float())
        return ops.deform_conv2d(rounded(state), off, mask, self.dcn_weight.float(),
                                 self.dcn_bias.float())


class ResBlocks(ResidualBlocksWithInputConv):
    """The input conv, lrelu and ``blocks`` residual blocks."""

    def __init__(self, cin: int, cout: int, blocks: int):
        super().__init__(cin, cout)
        for i in range(1, blocks):
            self.add_module(f"block{i}", ResidualBlockNoBN(cout))
        self.blocks = blocks

    def forward(self, x):
        x = lrelu(self.input_conv(x))
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class PyramidX8(nn.Module):
    """MRCF_x8 at ``mid`` channels, ``dg`` deformable groups at levels 0 and
    1 (``dg / 4`` at lv2, ``dg / 16`` at lv3), residue magnitude ``mag``,
    8x output; parameters on the meta device."""

    SCALE = 8
    BLOCKS = (3, 3, 1, 1)

    def __init__(self, mid: int = 64, dg: int = 16, mag: float = 10.0):
        super().__init__()
        m = self.mid = mid
        self.spynet = SPyNet()
        for k, g in enumerate((dg, dg, dg // 4, dg // 16)):
            self.add_module(f"align_lv{k}", LevelAlign(m, g, k, mag))
        for k, b in enumerate(self.BLOCKS):
            self.add_module(f"forward_resblocks_lv{k}", ResBlocks(2 * m, m, b))
        for k in range(3):
            self.add_module(f"upsample{k}", PixelShufflePack(m, m, 2))
        self.encoder_lr = LTE(m, 3)
        self.encoder_hr = LTEHR(m)
        self.conv_tttf_lv3 = Conv(2 * m, m)
        self.conv_hr_lv3 = Conv(m, m)
        self.conv_last_lv3 = Conv(m, 3)

    def encode(self, lr, fv):
        """lr (N, 3, h, w), fv (N, 4, 8h, 8w): the fovea frame and its mask ->
        (x_lr, (hr lv3, mask))."""
        base = lr
        for _ in range(3):
            base = ops.upsample(base, 2)
        fovea, mk = fv[:, :3], fv[:, 3:]
        blend = fovea * mk + base * (1.0 - mk)
        _, _, hr3 = self.encoder_hr(torch.cat([blend, base], dim=1))
        return self.encoder_lr(lr), (hr3, mk)

    def _tail(self, k, x, x_hr):
        """The lv3 mask blend, or the 2x upsample into the next level."""
        if k < 3:
            return lrelu(getattr(self, f"upsample{k}")(x))
        hr3, mk = x_hr
        blended = self.conv_tttf_lv3(torch.cat([x, hr3], dim=1))
        return mk * blended + (1.0 - mk) * x

    def _emit(self, lv3, lr):
        y = self.conv_last_lv3(lrelu(self.conv_hr_lv3(lv3)))
        return rounded(ops.emit_frame(y, lr))

    def step0(self, lr, x_lr, x_hr):
        """The cold frame: zero level states, no flow, no DCN."""
        cur = x_lr
        for k in range(4):
            x = getattr(self, f"forward_resblocks_lv{k}")(
                torch.cat([cur, torch.zeros_like(cur)], dim=1))
            cur = self._tail(k, x, x_hr)
        return cur, self._emit(cur, lr)

    def step(self, state, lr, pre_lr, x_lr, x_hr):
        flow = self.spynet(lr, pre_lr)
        states = [state]
        for _ in range(3):
            states.insert(0, ops.upsample(states[0], 0.5))
        cur = x_lr
        for k in range(4):
            if k > 0:
                flow = ops.upsample(flow, 2)
            warped = ops.flow_warp(states[k], flow)
            aligned = getattr(self, f"align_lv{k}")(cur, states[k], warped, flow)
            x = getattr(self, f"forward_resblocks_lv{k}")(torch.cat([cur, aligned], dim=1))
            cur = self._tail(k, x, x_hr)
        return cur, self._emit(cur, lr)
