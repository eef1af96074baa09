"""The first-generation full-pyramid models, NCHW inside, NHWC at the entry
(crfp_tpu/models/pyramid.py): ``CRFPPyramidX8`` (MRCF_x8 and, with
``cra``, MRCF_CRA_x8) and ``CRFPPyramidX4`` (MRCF_x4 / MRCF_CRA_x4).

A 4-level ladder where only the top level's feature ``lv3`` is recurrent
state: each frame re-derives the lower levels by cascaded 0.5x bilinear
resizes, warps every level by the bilinearly upsampled flow (its
magnitudes not rescaled, as in the reference), aligns each level with a
:class:`PyramidLevelAlign` (an inline DCN that samples the unwarped level
state), runs the level's resblocks over concat(carry-in, aligned), and
upsamples into the next level. SPyNet's forward flows only.

- X8 (levels 1x/2x/4x/8x of the LR frame): plain, the fovea blended into
  the input stream under its full-size mask and a ``conv_tttf_lv3`` blend
  at lv3, deformable groups (16, 16, 4, 1); CRA, the fovea patch encoded
  with the top-left crop of the upsampled LR and corner-patched in place at
  lv1/lv2/lv3, one group at every level.
- X4 (levels 1x/1x/2x/4x): no upsample after lv0, flow_lv1 = flow_lv0,
  lv0's state and warped state are lv1's, one 4x base; both variants blend
  the fovea into the input; CRA adds ``conv_tttf_lv{1,2}`` mask blends.

On the card the warps are kernel B with no clamp (the JAX package gathers),
the DCNs kernel A (``dcn_window=None``: unclamped, the JAX default and its
exact gather; else clamped to ±window), and each frame's emission
``conv_last_lv3(lrelu(conv_hr_lv3(lv3))) + upsample(lr)`` kernel C. Per
steady frame: X8 A 4, B 4, C 1; X4 A 4, B 3, C 1; the cold frame C 1.
Inference only, as in the JAX package: ``forward`` runs under
``torch.no_grad()`` (kernel D, the DCN backward, does not take O = 64).
"""

from __future__ import annotations

import torch
from torch import nn

from crfp_torch.nn.flow import SPyNet
from crfp_torch.nn.layers import (
    Conv,
    PixelShufflePack,
    ResidualBlocksWithInputConv,
    init_parameters,
    lrelu,
)
from crfp_torch.nn.lte import LTESimpleHR, LTESimpleLR
from crfp_torch.ops.cuda.dcn import deform_conv2d_windowed
from crfp_torch.ops.cuda.emit import emit_frame
from crfp_torch.ops.cuda.warp import flow_warp_windowed
from crfp_torch.ops.dcn_windowed import fusedprep_offsets_and_mask
from crfp_torch.ops.resize import upsample


class PyramidLevelAlign(nn.Module):
    """One level's inline DCN (crfp_tpu/models/pyramid.py:73-117):
    ``dcn_pre_lv{k}`` over concat(cur, warped, flow), lrelu, the two-conv
    block, zero-init offset and mask heads, offsets ``mag * tanh(raw)``
    plus the flipped flow broadcast to every tap, a sigmoid mask, and the
    modulated DCN of the level state with the identity-initialised
    ``dcn_weight_lv{k}``. Parameter names are the JAX tree's."""

    def __init__(self, mid_channels: int, deform_groups: int, level: int,
                 max_residue_magnitude: float = 10.0, window: int | None = None):
        super().__init__()
        m, g, lv = mid_channels, deform_groups, f"lv{level}"
        self.lv, self.mid_channels = lv, m
        self.max_residue_magnitude, self.window = max_residue_magnitude, window
        self.add_module(f"dcn_pre_{lv}", Conv(2 * m + 2, m))
        self.add_module(f"dcn_block_{lv}_conv1", Conv(m, m))
        self.add_module(f"dcn_block_{lv}_conv2", Conv(m, m))
        self.add_module(f"dcn_offset_{lv}", Conv(m, g * 18, init="zeros"))
        self.add_module(f"dcn_mask_{lv}", Conv(m, g * 9, init="zeros"))
        self.register_parameter(f"dcn_weight_{lv}", nn.Parameter(torch.empty(m, m, 3, 3)))
        self.register_parameter(f"dcn_bias_{lv}", nn.Parameter(torch.empty(m)))
        self.init_parameters(None)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator | None) -> None:
        """Identity DCN weight (centre tap, channel i -> i), zero bias."""
        w = getattr(self, f"dcn_weight_{self.lv}")
        w.zero_()
        idx = torch.arange(self.mid_channels)
        w[idx, idx, 1, 1] = 1.0
        getattr(self, f"dcn_bias_{self.lv}").zero_()

    def forward(self, cur, state, warped, flow):
        """cur, state, warped (N, m, H, W); flow (N, 2, H, W) as (dx, dy).
        Returns the aligned state (N, m, H, W)."""
        lv = self.lv
        feat = torch.cat([cur, warped, flow.to(cur.dtype)], dim=1)
        feat = lrelu(getattr(self, f"dcn_pre_{lv}")(feat))
        feat = lrelu(getattr(self, f"dcn_block_{lv}_conv1")(feat))
        feat = lrelu(getattr(self, f"dcn_block_{lv}_conv2")(feat))
        off, mask = fusedprep_offsets_and_mask(
            getattr(self, f"dcn_offset_{lv}")(feat), getattr(self, f"dcn_mask_{lv}")(feat),
            flow, self.max_residue_magnitude)
        return deform_conv2d_windowed(
            state.contiguous(), off, mask, getattr(self, f"dcn_weight_{lv}").float(),
            getattr(self, f"dcn_bias_{lv}").float(), max_displacement=self.window)


def _warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The unclamped warp (kernel B on the card)."""
    return flow_warp_windowed(x.contiguous(), flow.float().contiguous(), None)


class _Pyramid(nn.Module):
    """What the X8 and X4 models share: the modules but the upsamples, the
    encoders, the flows, the cold frame and the emission. Subclasses set
    ``SCALE`` and define ``_tail`` (a level's injection and upsample) and
    ``_frame`` (a steady frame)."""

    SCALE = 8

    def _build(self, m, dgs, cra, max_residue_magnitude, dcn_window, ups, device, seed):
        """The modules (``ups``: the levels followed by a PixelShufflePack
        2x, named ``upsample{k}``), initialised from ``seed`` on ``device``."""
        self.mid_channels, self.cra = m, cra
        self.spynet = SPyNet()
        for k in range(4):
            self.add_module(f"align_lv{k}", PyramidLevelAlign(
                m, dgs[k], k, max_residue_magnitude, window=dcn_window))
        for k, b in enumerate((3, 3, 1, 1)):
            self.add_module(f"forward_resblocks_lv{k}",
                            ResidualBlocksWithInputConv(2 * m, m, b))
        for k in ups:
            self.add_module(f"upsample{k}", PixelShufflePack(m, m, 2))
        self.encoder_lr = LTESimpleLR(m, 3)
        self.encoder_hr = LTESimpleHR(m)
        if cra:
            self.conv_tttf_lv1 = Conv(2 * m, m)
            self.conv_tttf_lv2 = Conv(2 * m, m)
        self.conv_tttf_lv3 = Conv(2 * m, m)
        self.conv_hr_lv3 = Conv(m, m)
        self.conv_last_lv3 = Conv(m, 3)
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def _level(self, k, cur, state, warped, flow):
        """Level k of a steady frame: align, then the level's resblocks."""
        aligned = getattr(self, f"align_lv{k}")(cur, state, warped, flow)
        return getattr(self, f"forward_resblocks_lv{k}")(torch.cat([cur, aligned], dim=1))

    def _frame0(self, cur, hr, mk):
        """The cold frame (zero states, no flow, no DCN): each level's
        resblocks over concat(cur, zeros), then the level's tail."""
        for k in range(4):
            x = getattr(self, f"forward_resblocks_lv{k}")(
                torch.cat([cur, torch.zeros_like(cur)], dim=1))
            cur = self._tail(k, x, hr[k], mk[k])
        return cur

    def _mask_blend(self, k, x, x_hr, mk):
        blended = getattr(self, f"conv_tttf_lv{k}")(torch.cat([x, x_hr], dim=1))
        return mk * blended + (1.0 - mk) * x

    def _inputs(self, lrs, fvs, mks):
        """Flows, LR features, the HR pyramid and the mask pyramid, per clip.
        lrs (n, t, 3, h, w); the base is cascaded 2x upsamples to the
        model's scale."""
        n, t, c, h, w = lrs.shape
        flat = lrs.reshape(n * t, c, h, w)
        # forward flows only (the reference's backward ones are unused)
        flows = self.spynet(lrs[:, 1:].reshape(n * (t - 1), c, h, w),
                            lrs[:, :-1].reshape(n * (t - 1), c, h, w))
        flows = flows.reshape(n, t - 1, 2, h, w)
        s = self.SCALE
        base = flat
        while base.shape[-1] < s * w:
            base = upsample(base, 2)
        x_lr = self.encoder_lr(flat).reshape(n, t, self.mid_channels, h, w)
        if mks is None:  # X8 CRA: the fovea patch beside the crop of the base
            ph, pw = fvs.shape[-2:]
            enc_in = torch.cat([fvs.reshape(n * t, c, ph, pw), base[:, :, :ph, :pw]], dim=1)
        else:
            mks = mks.to(lrs.dtype)
            fvb = fvs * mks + base.reshape(n, t, c, s * h, s * w) * (1.0 - mks)
            enc_in = torch.cat([fvb.reshape(n * t, c, s * h, s * w), base], dim=1)

        def seq(a):
            return a.reshape(n, t, *a.shape[1:])

        x_hrs = (None, *(seq(a) for a in self.encoder_hr(enc_in)))
        if mks is None:
            mk_pyr = (None,) * 4
        else:
            mk3 = mks.reshape(n * t, 1, s * h, s * w)
            mk2 = upsample(mk3, 0.5)
            mk_pyr = (None, seq(upsample(mk2, 0.5)), seq(mk2), seq(mk3))
        return flows, x_lr, x_hrs, mk_pyr

    def _emit(self, lv3, lr):
        """conv_last_lv3(lrelu(conv_hr_lv3(lv3))) + the bilinear base of lr
        (kernel C), an NHWC frame."""
        y = self.conv_last_lv3(lrelu(self.conv_hr_lv3(lv3)))
        return emit_frame(y.contiguous(), lr.contiguous(), r=1)

    @torch.no_grad()
    def forward(self, lrs, fvs, mks=None):
        """lrs (n, t, h, w, 3), fvs and mks (n, t, sH, sW, 3 / 1) NHWC (X8
        CRA: fvs the top-left fovea patch and no mks) -> frames (n, t, sh,
        sw, 3), s the model's scale."""
        if (mks is None) != (self.cra and self.SCALE == 8):
            raise ValueError("MRCF_CRA_x8 takes (lrs, fvs); the other pyramids take "
                             "(lrs, fvs, mks)")

        def nchw(a):
            return None if a is None else a.permute(0, 1, 4, 2, 3)

        lrs, fvs, mks = nchw(lrs), nchw(fvs), nchw(mks)
        flows, x_lr, x_hrs, mk_pyr = self._inputs(lrs, fvs, mks)
        t = lrs.shape[1]
        outs, lv3 = [], None
        for i in range(t):
            hr_i = tuple(None if a is None else a[:, i] for a in x_hrs)
            mk_i = tuple(None if a is None else a[:, i] for a in mk_pyr)
            if i == 0:
                lv3 = self._frame0(x_lr[:, 0], hr_i, mk_i)
            else:
                lv3 = self._frame(lv3, flows[:, i - 1], x_lr[:, i], hr_i, mk_i)
            outs.append(self._emit(lv3, lrs[:, i]))
        return torch.stack(outs, dim=1)


class CRFPPyramidX8(_Pyramid):
    """MRCF_x8 (``cra=False``: ``forward(lrs, fvs, mks)`` with the full-size
    fovea and mask) and MRCF_CRA_x8 (``cra=True``: ``forward(lrs, fvs)``
    with the top-left fovea patch), 8x output (crfp_tpu/models/pyramid.py:
    119-279). ``device``: where the model lives (default ``cuda``; tests
    pass ``cpu``). ``seed``: seeds the ``torch.Generator`` that initialises
    the parameters."""

    SCALE = 8

    def __init__(self, mid_channels: int = 64, cra: bool = False, dg_num: int = 16,
                 max_residue_magnitude: float = 10.0, dcn_window: int | None = None,
                 *, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dgs = (1, 1, 1, 1) if cra else (dg_num, dg_num, dg_num // 4, dg_num // 16)
        self._build(mid_channels, dgs, cra, max_residue_magnitude, dcn_window, (0, 1, 2),
                    device, seed)

    def _inject(self, k, x, x_hr, mk):
        """CRA: corner-patch conv_tttf_lv{k}(concat(corner, x_hr)) in place;
        plain: the lv3-only full-size mask blend."""
        if self.cra:
            ph, pw = x_hr.shape[-2:]
            x[:, :, :ph, :pw] = getattr(self, f"conv_tttf_lv{k}")(
                torch.cat([x[:, :, :ph, :pw], x_hr], dim=1))
            return x
        return self._mask_blend(3, x, x_hr, mk) if k == 3 else x

    def _tail(self, k, x, x_hr, mk):
        if k >= 1:
            x = self._inject(k, x, x_hr, mk)
        return lrelu(getattr(self, f"upsample{k}")(x)) if k < 3 else x

    def _frame(self, lv3, flow0, cur, hr, mk):
        flows = [flow0]
        states = [lv3]
        for _ in range(3):
            flows.append(upsample(flows[-1], 2))
            states.insert(0, upsample(states[0], 0.5))
        for k in range(4):
            warped = _warp(states[k], flows[k])
            cur = self._tail(k, self._level(k, cur, states[k], warped, flows[k]), hr[k], mk[k])
        return cur


class CRFPPyramidX4(_Pyramid):
    """MRCF_x4 / MRCF_CRA_x4 (crfp_tpu/models/pyramid.py:282-429): both take
    ``forward(lrs, fvs, mks)`` with the full-size 4x fovea and mask; levels
    1x/1x/2x/4x; deformable groups (16, 16, 4, 1) both ways; ``cra`` adds
    mask blends at lv1 and lv2. ``device`` and ``seed`` as
    :class:`CRFPPyramidX8`'s."""

    SCALE = 4

    def __init__(self, mid_channels: int = 64, cra: bool = False, dg_num: int = 16,
                 max_residue_magnitude: float = 10.0, dcn_window: int | None = None,
                 *, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dgs = (dg_num, dg_num, dg_num // 4, dg_num // 16)
        # upsamples after lv1 and lv2 only, named 1 and 2 as in the reference
        self._build(mid_channels, dgs, cra, max_residue_magnitude, dcn_window, (1, 2),
                    device, seed)

    def _tail(self, k, x, x_hr, mk):
        """The mask blend (CRA at lv1-3, plain at lv3), then a bare lrelu
        after lv0 and an upsample after lv1 and lv2."""
        if k == 3 or (k >= 1 and self.cra):
            x = self._mask_blend(k, x, x_hr, mk)
        if k == 0:
            return lrelu(x)
        return lrelu(getattr(self, f"upsample{k}")(x)) if k < 3 else x

    def _frame(self, lv3, flow0, cur, hr, mk):
        flow2 = upsample(flow0, 2)
        flows = (flow0, flow0, flow2, upsample(flow2, 2))
        st2 = upsample(lv3, 0.5)
        st1 = upsample(st2, 0.5)
        states = (st1, st1, st2, lv3)
        w0 = _warp(st1, flow0)  # lv0's warped state is lv1's too
        warpeds = (w0, w0, _warp(st2, flow2), _warp(lv3, flows[3]))
        for k in range(4):
            cur = self._tail(k, self._level(k, cur, states[k], warpeds[k], flows[k]),
                             hr[k], mk[k])
        return cur
