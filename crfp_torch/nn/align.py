"""Flow-guided deformable alignment, NCHW (crfp_tpu/nn/align.py:94-337).

:class:`PlainAlign` is the no-DCN ablation block of the ``no_dcn`` trunk
(:94-104): two conv + lrelu over concat(cur, warped, flow), no sampling.

concat(cur, warped_prev, flow) -> two conv+lrelu -> [fuse the previous
stage's offset feature] -> zero-init offset head ``mag * tanh(raw)`` plus
the flipped flow, and a zero-init sigmoid mask head -> modulated DCN with
an identity-initialised weight. Plain layout only.

- Per-tap mode (dcn_0/1/2, G groups): head channel ``(g*K2 + k)*2 +
  {dy, dx}`` — which is already the DCN's packed offset layout — and one
  mask per (group, tap).
- Repeat mode (dcn_3, G=1): one (dy, dx) and one mask per pixel for every
  tap; the raw offset channels are packed ``[y*g | x*g]``
  (crfp_tpu/nn/align.py:237-240).

Offsets are (dy, dx) while flow is (dx, dy). The DCN is kernel A's
dispatcher, with offsets clamped to ±window (``window=None``: no clamp,
the exact DCN). With ``fused_prep`` a per-tap windowed stage hands the two
heads' raw outputs and the flow to kernel E's dispatcher instead, which
computes tanh, flow add, clip and sigmoid inside its one launch
(crfp_tpu/nn/align.py:141-147, :282-306); it is inference only, so a call
that autograd records takes the structured path (kernel A forward, kernel
D backward), as does repeat mode. The JAX dispatch is also limited to the
TPU and to bf16 by its kernel's scratch memory; that is not math, and
kernel E runs float32 and bfloat16. The JAX package's ``s2d`` operand
forms are layouts of the same math and are not carried.

``anchor`` (windowed; repeat mode: dcn_3 under ``ModelConfig.dcn_anchor``;
per-tap: a stage that JAX's ``DCNAlign(anchor=True)`` also takes,
crfp_tpu/nn/align.py:325-336, though no model of the JAX package sets it)
is math: per-cell anchored windows, which sample past ±window where the
motion of a cell of the TPU kernel's grid is coherent
(crfp_tpu/ops/pallas/dcn.py:771-780). The grid is the one the JAX kernel
resolves for this call (:func:`crfp_torch.ops.anchor.dcn_geometry`: x's
dtype and its width, shared or per-tap; the JAX model's s2d operand form
resolves the same grid for this request); kernel A's anchored mode on the
card, the plain version on the CPU. ``anchor_vjp``: the training grid,
which JAX's anchored backward resolves (crfp_tpu/nn/align.py:44-63,
``anchor_vjp``); kernel D's anchored mode differentiates it on the card.
Kernel E has no anchored mode, nor has the TPU's fused kernel, so an
anchored per-tap stage takes the structured path (kernel A forward, kernel
D backward) under ``fused_prep`` too. The JAX package differs there on the
TPU: its fused branch (crfp_tpu/nn/align.py:282-310) takes a bf16 per-tap
stage with ``fused_prep`` and passes no anchor, so on the TPU that stage is
served with the ±window clamp. Without ``fused_prep``, and in f32, the TPU
branch anchors it as the port does (JAX's CPU dispatch drops the anchor,
:41-84).
"""

from __future__ import annotations

import torch
from torch import nn

from crfp_torch.nn.layers import Conv, PixelShufflePack, lrelu
from crfp_torch.ops.anchor import dcn_geometry
from crfp_torch.ops.cuda.dcn import deform_conv2d_windowed
from crfp_torch.ops.cuda.dcn_fused import deform_conv2d_fusedprep
from crfp_torch.ops.dcn_windowed import fusedprep_offsets_and_mask


class PlainAlign(nn.Module):
    """conv1 + lrelu, conv2 + lrelu: 2*mid + 2 channels (the concat of cur,
    warped and flow) -> mid."""

    def __init__(self, mid_channels: int):
        super().__init__()
        self.conv1 = Conv(2 * mid_channels + 2, mid_channels)
        self.conv2 = Conv(mid_channels, mid_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lrelu(self.conv2(lrelu(self.conv1(x))))


class DCNAlign(nn.Module):
    def __init__(
        self,
        mid_channels: int,
        deform_groups: int = 8,
        kernel: int = 3,
        max_residue_magnitude: float = 10.0,
        *,
        repeat: bool = False,
        pre_offset: bool = False,
        interpolate: str = "none",
        window: int | None = None,
        in_channels: int | None = None,
        pre_offset_channels: int | None = None,
        fused_prep: bool = False,
        anchor: bool = False,
        anchor_vjp: bool = False,
    ):
        """``in_channels``: channels of concat(cur, warped_prev, flow),
        default 2*mid + 2. ``pre_offset_channels``: channels of the
        incoming offset feature, default mid (only read with
        ``interpolate='pixelshuffle'``). ``fused_prep``: kernel E for a
        per-tap windowed stage outside autograd; ignored in repeat mode,
        without a window, under grad and anchored. ``anchor``: per-cell
        anchored windows (repeat mode or per-tap; no effect without a
        window); ``anchor_vjp``: on the training grid. No parameter
        depends on these."""
        super().__init__()
        m, g, k = mid_channels, deform_groups, kernel
        if repeat and g != 1:
            raise ValueError("repeat mode is defined for one deform group")
        if interpolate not in ("none", "pixelshuffle"):
            raise ValueError(f"interpolate={interpolate!r}")
        self.mid_channels, self.deform_groups, self.kernel = m, g, k
        self.max_residue_magnitude = max_residue_magnitude
        self.repeat, self.pre_offset = repeat, pre_offset
        self.interpolate, self.window = interpolate, window
        self.fused_prep = fused_prep
        self.anchor, self.anchor_vjp = anchor, anchor_vjp
        k2 = k * k
        self.dcn_block_conv1 = Conv(in_channels or 2 * m + 2, m)
        self.dcn_block_conv2 = Conv(m, m)
        if pre_offset:
            if interpolate == "pixelshuffle":
                self.upsample = PixelShufflePack(pre_offset_channels or m, m, 4)
            self.conv_fuse = Conv(2 * m, m)
        self.dcn_offset = Conv(m, g * 2 * (1 if repeat else k2), init="zeros")
        self.dcn_mask = Conv(m, g * (1 if repeat else k2), init="zeros")
        self.dcn_weight = nn.Parameter(torch.empty(m, m, k, k))
        self.dcn_bias = nn.Parameter(torch.empty(m))
        self.init_parameters(None)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator | None) -> None:
        """Identity DCN weight (centre tap, channel i -> i), zero bias."""
        self.dcn_weight.zero_()
        c = self.kernel // 2
        idx = torch.arange(self.mid_channels)
        self.dcn_weight[idx, idx, c, c] = 1.0
        self.dcn_bias.zero_()

    def forward(
        self,
        cur_x: torch.Tensor,
        pre_x: torch.Tensor,
        pre_x_aligned: torch.Tensor,
        flow: torch.Tensor,
        pre_offset_feat: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (aligned pre_x, offset feature for propagation).

        flow: (N, 2, H, W), channels (dx, dy), at cur_x's resolution."""
        pre = None
        if pre_offset_feat is not None:
            assert self.pre_offset
            pre = pre_offset_feat
            if self.interpolate == "pixelshuffle":
                pre = self.upsample(pre_offset_feat) * 2.0
        feat = self.features(cur_x, pre_x_aligned, flow, pre)
        if (self.fused_prep and self.window is not None and not self.repeat
                and not self.anchor and not torch.is_grad_enabled()):
            aligned = deform_conv2d_fusedprep(
                pre_x.contiguous(), self.dcn_offset(feat).contiguous(),
                self.dcn_mask(feat).contiguous(), flow.float().contiguous(), self.dcn_weight.float(),
                self.dcn_bias.float(), max_residue_magnitude=self.max_residue_magnitude,
                max_displacement=self.window)
            return aligned, feat
        return self.deform(pre_x, *self.offsets(feat, flow)), feat

    def features(self, cur_x: torch.Tensor, pre_x_aligned: torch.Tensor, flow: torch.Tensor,
                 pre: torch.Tensor | None) -> torch.Tensor:
        """The offset feature: two conv + lrelu over concat(cur_x,
        pre_x_aligned, flow), then conv_fuse + lrelu with ``pre``, the
        previous stage's offset feature at this resolution (already
        interpolated; None: no fuse)."""
        feat = torch.cat([cur_x, pre_x_aligned, flow.to(cur_x.dtype)], dim=1)
        feat = lrelu(self.dcn_block_conv1(feat))
        feat = lrelu(self.dcn_block_conv2(feat))
        if pre is not None:
            feat = lrelu(self.conv_fuse(torch.cat([feat, pre], dim=1)))
        return feat

    def offsets(self, feat: torch.Tensor, flow: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The heads over ``feat``: kernel A's float32 offset and mask."""
        n, _, h, w = feat.shape
        g, mag = self.deform_groups, self.max_residue_magnitude
        # the kernel takes f32 offsets/masks/weights whatever x's dtype
        if self.repeat:
            raw = self.dcn_offset(feat).float()
            flow = flow.float()
            off_y = mag * torch.tanh(raw[:, :g]) + flow[:, 1:2]
            off_x = mag * torch.tanh(raw[:, g:]) + flow[:, 0:1]
            off = torch.stack([off_y, off_x], dim=2).reshape(n, -1, h, w)
            mask = torch.sigmoid(self.dcn_mask(feat).float())
            return off, mask
        return fusedprep_offsets_and_mask(self.dcn_offset(feat), self.dcn_mask(feat), flow, mag)

    def deform(self, pre_x: torch.Tensor, off: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Kernel A's modulated DCN of ``pre_x`` at ``off`` and ``mask``
        (:meth:`offsets`' layouts), windowed and anchored as configured."""
        g = self.deform_groups
        kw = dict(shared_taps=self.repeat, shared_mask=self.repeat)
        if self.anchor and self.window is not None:
            _, c, ph, pw = pre_x.shape
            kw["anchor"] = dcn_geometry(ph, pw, c, self.mid_channels, g, self.kernel,
                                        self.window, bf16=pre_x.dtype == torch.bfloat16,
                                        shared_taps=self.repeat, shared_mask=self.repeat,
                                        fullgrad=self.anchor_vjp)
        return deform_conv2d_windowed(
            pre_x.contiguous(), off, mask, self.dcn_weight.float(),
            self.dcn_bias.float(), max_displacement=self.window, **kw)
