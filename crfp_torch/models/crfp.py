"""The batch CRFP trunk, every variant (crfp_tpu/models/crfp.py:157-720),
the model the training step differentiates and ``StreamingRunner`` steps.

``forward`` takes a whole clip: the flow of every (t-1, t) frame pair in
one FNet batch, the two encoders over all B*T frames at once, then
``step0`` on the first frame and a Python loop of ``step`` over the rest,
each step under ``torch.utils.checkpoint`` (non-reentrant) when
``cfg.remat`` is set and autograd records: the JAX package's
``nn.scan(nn.remat(step))``.

The six variants of ``crfp_tpu.models.crfp.VARIANTS``, in plain layout
(``hr_s2d=False``), with the fovea blended through its mask:

- ``v18`` (the trained model) and ``v18_cra``: the DSV trunk, channel-split
  lv states beside the HR state; ``v18_cra`` adds the LTE pyramid and a
  texture blend after each of resblocks 0-2. Three warps a step: the HR
  state at ``dcn_window_hr`` (:508), ``lv3_state`` and the stacked lv
  states at ``dcn_window`` (:526-528).
- ``v13`` / ``v15`` (``v15`` also concatenates the warped state, :619):
  with ``hr_dcn`` the HR state is warped at ``dcn_window_hr`` and
  downsampled (:612-614) and dcn_3 runs in repeat mode at 8x; without it
  ``lv3_state`` is warped unclamped (:617) and dcn_3 is a per-tap stage at
  1/4 size before the upsampling.
- ``no_dcn``: ``PlainAlign`` convs in place of the DCN stages, one
  unclamped ``lv3_state`` warp (:578).
- ``basic_fvsr``: the fovea blended once into the 1/4-size input feature,
  four parallel states warped unclamped as one stack (:464), per-tap
  dcn_0..3; ``fg`` is ignored.

Every warp is ``flow_warp_windowed``: kernel B forward and kernel D at k=1
backward on the card, ``None`` for the JAX package's unclamped
``flow_warp``, whose XLA gather takes no window even when ``dcn_window``
is set. The DCN stages run kernel A forward and kernel D backward
(crfp_torch/ops/cuda), or, with ``cfg.dcn_fused`` and outside autograd,
kernel E for dcn_0/1/2. With ``cfg.y_only`` the frame has one channel
and its base is the x8 upsampled luma of the LR frame (:310-312).

Module names follow the flax tree, so a flat ``.npz`` checkpoint of the
JAX ``CRFP`` of the same variant loads strictly through
``crfp_torch.params.from_jax``; a module the JAX trunk never calls has
no leaves there and is not built here (``basic_fvsr`` has no
``downsample``). Inputs and outputs are NHWC like the JAX model; inside,
everything is NCHW.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from crfp_torch.models.config import ModelConfig
from crfp_torch.nn.align import DCNAlign, PlainAlign
from crfp_torch.nn.flow import FNet, SPyNet
from crfp_torch.nn.layers import (
    Conv,
    PixelShufflePack,
    PixelUnShufflePackV2,
    ResidualBlocksWithInputConv,
    init_parameters,
    lrelu,
)
from crfp_torch.nn.lte import LTESimpleHR, LTESimpleHRPS, LTESimpleHRSingle, LTESimpleLR
from crfp_torch.ops.color import rgb2y
from crfp_torch.ops.cuda.warp import flow_warp_windowed
from crfp_torch.ops.resize import resize_bilinear, upsample


def _tree_map(fn, x):
    """``fn`` over a tensor or over each tensor of a tuple (v18_cra's x_hr)."""
    return tuple(fn(a) for a in x) if isinstance(x, tuple) else fn(x)


class CRFP(nn.Module):
    """``forward(lrs, fvs, mks)``: lrs (B, T, h, w, 3), fvs (B, T, 8h, 8w,
    3), mks (B, T, 8h, 8w, 1) -> (B, T, 8h, 8w, 3), or 1 channel with
    ``y_only``, NHWC.

    ``device``: where the model lives (default ``cuda``; tests pass
    ``cpu``). ``seed``: seeds the ``torch.Generator`` that initialises the
    parameters."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        v = cfg.variant
        m, last = cfg.mid_channels, cfg.last_channels
        dg, dk, mag = cfg.deform_groups, cfg.dcn_kernel, cfg.max_residue_magnitude
        # the flow net reads the RGB LR frames, with y_only too (:191)
        self.spynet = FNet(3) if cfg.flow_net == "fnet" else SPyNet()
        if v == "no_dcn":
            self.dcn_0, self.dcn_1, self.dcn_2, self.dcn_3 = (PlainAlign(m) for _ in range(4))
        else:
            lv = dict(window=cfg.dcn_window, fused_prep=cfg.dcn_fused)  # 1/4-res stages
            self.dcn_0 = DCNAlign(m, dg, dk, mag, **lv)
            self.dcn_1 = DCNAlign(m, dg, dk, mag, pre_offset=cfg.offset_prop, **lv)
            self.dcn_2 = DCNAlign(m, dg, dk, mag, pre_offset=cfg.offset_prop, **lv)
            if cfg.hr_dcn:
                self.dcn_3 = DCNAlign(last, 1, dk, mag, repeat=True,
                                      pre_offset=cfg.offset_prop, interpolate="pixelshuffle",
                                      window=cfg.dcn_window_hr, pre_offset_channels=m)
            else:  # per-tap at 1/4 size, never kernel E (:213-215)
                self.dcn_3 = DCNAlign(m, dg, dk, mag, pre_offset=cfg.offset_prop,
                                      window=cfg.dcn_window)
        self.encoder_lr = LTESimpleLR(m, 3)
        if v == "basic_fvsr":
            self.encoder_hr = LTESimpleHR(m)
            self.conv_tttf = Conv(2 * m, m)
        elif v == "v18_cra":
            self.encoder_hr = LTESimpleHRPS(last)
            self.conv_tttf = Conv(2 * last, last)
            for i in range(3):  # concat(trunk, 1/4-size texture level) -> mid
                self.add_module(f"conv_tttf_{i}", Conv(m + 4 * last, m))
        else:
            self.encoder_hr = LTESimpleHRSingle(last, 6)
            self.conv_tttf = Conv(2 * last, last)
        self.conv_last = Conv(last, 1 if cfg.y_only else 3)
        # input: concat(trunk, aligned[, warped state for v15]); for the DSV
        # trunk concat(keep, lv state, aligned) = 2*mid
        reps = 3 if v == "v15" else 2
        self.forward_resblocks_0 = ResidualBlocksWithInputConv(reps * m, m)
        self.forward_resblocks_1 = ResidualBlocksWithInputConv(reps * m, m)
        self.forward_resblocks_2 = ResidualBlocksWithInputConv(reps * m, m)
        self.forward_resblocks_3 = (ResidualBlocksWithInputConv(reps * last, last)
                                    if cfg.hr_dcn else ResidualBlocksWithInputConv(reps * m, m))
        if v != "basic_fvsr":
            self.downsample = PixelUnShufflePackV2(last, m, 4)
        up = cfg.keep_channels if cfg.is_dsv else m
        self.upsample = PixelShufflePack(m, up, 2)
        self.upsample_post = PixelShufflePack(up, last, 4)
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    # ---- per-frame pieces (NCHW) ----------------------------------------

    def encode_frame(self, lr, fv, mk):
        """Encoders and the fovea blend (:253-278): lr (N, 3, h, w); fv, mk at
        8x. Returns (x_lr, x_hr); x_hr is the 4-tuple of levels for
        v18_cra and the 1/4-size level for basic_fvsr."""
        lr_up = upsample(lr, self.cfg.scale)
        mkf = mk.to(lr.dtype)
        blend = fv * mkf + lr_up * (1.0 - mkf)
        hr_in = torch.cat([blend, lr_up], dim=1)
        if self.cfg.variant == "basic_fvsr":
            return self.encoder_lr(lr), self.encoder_hr.forward_lv1(hr_in)
        return self.encoder_lr(lr), self.encoder_hr(hr_in)

    def compute_flow(self, lr_cur, lr_prev):
        return self.spynet(lr_cur, lr_prev)

    def _base(self, lr):
        """The bilinear x8 base: of the luma with ``y_only`` (:310-312)."""
        if self.cfg.y_only:
            lr = rgb2y(lr.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return upsample(lr, self.cfg.scale)

    def _dsv_chunk(self, x):
        chunks = torch.chunk(x, 4, dim=1)
        sr = self.cfg.split_ratio
        return torch.cat(chunks[:sr], dim=1), torch.cat(chunks[sr:], dim=1)

    def _mk_lv2(self, mk, lr):
        """The fovea mask at 1/4 size (basic_fvsr, v18_cra)."""
        _, _, h, w = lr.shape
        return resize_bilinear(mk.to(lr.dtype), (2 * h, 2 * w))

    def _cra_blend(self, x, x_hr_lv, mk_lv2, idx):
        """v18_cra's texture blend after resblocks ``idx`` (:355-357)."""
        blend = getattr(self, f"conv_tttf_{idx}")(torch.cat([x, x_hr_lv], dim=1))
        return mk_lv2 * blend + (1.0 - mk_lv2) * x

    def _reconstruct(self, y, x_hr, mk, lr):
        """Fovea texture blend through the mask, conv_last and the bilinear
        x8 base (:336-353). Returns (y, frame)."""
        mkf = mk.to(y.dtype)
        blended = self.conv_tttf(torch.cat([y, x_hr], dim=1))
        y = lrelu(mkf * blended + (1.0 - mkf) * y)
        return y, self.conv_last(y) + self._base(lr)

    def _fovea_feature(self, feat, x_hr, mk, lr):
        """basic_fvsr's input feature: the fovea texture blended in once at
        1/4 size (:383-385, :460-462)."""
        mk_lv2 = self._mk_lv2(mk, lr)
        blended = self.conv_tttf(torch.cat([feat, x_hr], dim=1))
        return mk_lv2 * blended + (1.0 - mk_lv2) * feat

    def step0(self, lr, x_lr, x_hr, mk):
        """First frame: zero states, no warping (:365-435)."""
        cfg = self.cfg
        n, _, h, w = lr.shape
        rbs = (self.forward_resblocks_0, self.forward_resblocks_1, self.forward_resblocks_2)
        z_lv3 = lr.new_zeros(n, cfg.mid_channels, 2 * h, 2 * w)
        z_hr = lr.new_zeros(n, cfg.last_channels, cfg.scale * h, cfg.scale * w)
        x = self.upsample(x_lr)

        if cfg.variant == "basic_fvsr":
            x, ps = self._fovea_feature(x, x_hr, mk, lr), []
            for rb in (*rbs, self.forward_resblocks_3):
                x = rb(torch.cat([x, z_lv3], dim=1))
                ps.append(x)
            y = lrelu(self.upsample_post(x))
            return {"p": tuple(ps)}, self.conv_last(y) + self._base(lr)

        if cfg.is_dsv:
            cra = cfg.variant == "v18_cra"
            if cra:
                mk_lv2, x_hr_lv3 = self._mk_lv2(mk, lr), x_hr[3]
            else:
                x_hr_lv3 = x_hr
            z_lv = lr.new_zeros(n, cfg.state_channels, 2 * h, 2 * w)
            lvs = []
            for idx, rb in enumerate(rbs):
                x = rb(torch.cat([x, z_lv3, z_lv], dim=1))
                if cra:
                    x = self._cra_blend(x, x_hr[idx], mk_lv2, idx)
                x, carry = self._dsv_chunk(x)
                lvs.append(carry)
            x = lrelu(self.upsample_post(x))
            y = self.forward_resblocks_3(torch.cat([x, z_hr], dim=1))
            y, out = self._reconstruct(y, x_hr_lv3, mk, lr)
            return {"hr": y, "lv": tuple(lvs)}, out

        # v13 / v15 / no_dcn
        zeros = 2 if cfg.variant == "v15" else 1
        for rb in rbs:
            x = rb(torch.cat([x] + [z_lv3] * zeros, dim=1))
        if cfg.hr_dcn:
            x = lrelu(self.upsample_post(x))
            y = self.forward_resblocks_3(torch.cat([x] + [z_hr] * zeros, dim=1))
        else:
            y = self.forward_resblocks_3(torch.cat([x] + [z_lv3] * zeros, dim=1))
            y = lrelu(self.upsample_post(y))
        y, out = self._reconstruct(y, x_hr, mk, lr)
        return {"hr": y}, out

    def step(self, state, lr, x_lr, x_hr, mk, flow, fg=None):
        """One recurrent step (:437-667). flow (N, 2, h, w), channels (dx,
        dy), from this frame to the previous one. fg: optional (N, 1, 8h,
        8w) regional-computation gate that multiplies the trunk features
        before resblocks 1-2 (at 1/4 size) and 3 (at the size it runs at)
        (:452-455); basic_fvsr ignores it."""
        cfg = self.cfg
        fg_lv3 = fg_lv0 = None
        if fg is not None:
            fg_lv3 = fg.to(lr.dtype)
            fg_lv0 = resize_bilinear(fg_lv3, (fg.shape[2] // 4, fg.shape[3] // 4))
        feat_prop_lv0 = self.upsample(x_lr)
        # the warp and DCN kernels take f32 flow whatever the activations' dtype
        flow_lv3 = (upsample(flow, 2) * 2.0).float()
        rbs = (self.forward_resblocks_0, self.forward_resblocks_1, self.forward_resblocks_2)
        dcns = (self.dcn_0, self.dcn_1, self.dcn_2)

        if cfg.variant == "basic_fvsr":
            return self._step_basic_fvsr(state["p"], lr, feat_prop_lv0, x_hr, mk, flow_lv3)

        if cfg.is_dsv:
            return self._step_dsv(state, lr, feat_prop_lv0, x_hr, mk, flow, flow_lv3,
                                  fg_lv0, fg_lv3)
        hr_state = state["hr"]

        if cfg.variant == "no_dcn":
            lv3_state = self.downsample(hr_state)
            lv3_warped = flow_warp_windowed(lv3_state, flow_lv3, None)
            flow_in = flow_lv3.to(lv3_warped.dtype)
            x = feat_prop_lv0
            for idx, (blk, rb) in enumerate(zip(dcns, rbs)):
                x = torch.cat([x, blk(torch.cat([x, lv3_warped, flow_in], dim=1))], dim=1)
                if fg_lv0 is not None and idx > 0:
                    x = x * fg_lv0
                x = rb(x)
            y = torch.cat([x, self.dcn_3(torch.cat([x, lv3_warped, flow_in], dim=1))], dim=1)
            if fg_lv0 is not None:
                y = y * fg_lv0
            y = lrelu(self.upsample_post(self.forward_resblocks_3(y)))
            y, out = self._reconstruct(y, x_hr, mk, lr)
            return {"hr": y}, out

        # ---- v13 / v15 ----
        if cfg.hr_dcn:
            flow_lv0 = (upsample(flow, cfg.scale) * float(cfg.scale)).float()
            hr_warped = flow_warp_windowed(hr_state, flow_lv0, cfg.dcn_window_hr)
            lv3_warped = self.downsample(hr_warped)
            lv3_state = self.downsample(hr_state)
        else:
            lv3_state = self.downsample(hr_state)
            lv3_warped = flow_warp_windowed(lv3_state, flow_lv3, None)
        three_way = [lv3_warped] if cfg.variant == "v15" else []
        offset, x = None, feat_prop_lv0
        for idx, (dcn, rb) in enumerate(zip(dcns, rbs)):
            aligned, offset = dcn(x, lv3_state, lv3_warped, flow_lv3,
                                  offset if cfg.offset_prop else None)
            x = torch.cat([x, aligned] + three_way, dim=1)
            if fg_lv0 is not None and idx > 0:
                x = x * fg_lv0
            x = rb(x)
        offset = offset if cfg.offset_prop else None
        if cfg.hr_dcn:
            x = lrelu(self.upsample_post(x))
            aligned, _ = self.dcn_3(x, hr_state, hr_warped, flow_lv0, offset)
            y = torch.cat([x, aligned] + ([hr_warped] if three_way else []), dim=1)
            if fg_lv3 is not None:
                y = y * fg_lv3
            y = self.forward_resblocks_3(y)
        else:
            aligned, _ = self.dcn_3(x, lv3_state, lv3_warped, flow_lv3, offset)
            y = torch.cat([x, aligned] + three_way, dim=1)
            if fg_lv0 is not None:
                y = y * fg_lv0
            y = lrelu(self.upsample_post(self.forward_resblocks_3(y)))
        y, out = self._reconstruct(y, x_hr, mk, lr)
        return {"hr": y}, out

    def _step_basic_fvsr(self, ps, lr, feat_prop_lv0, x_hr, mk, flow_lv3):
        """basic_fvsr's step (:459-484): the four states warped as one stack."""
        cfg = self.cfg
        warped = torch.chunk(flow_warp_windowed(torch.cat(ps, dim=1), flow_lv3, None), 4,
                             dim=1)
        x = self._fovea_feature(feat_prop_lv0, x_hr, mk, lr)
        offset, new = None, []
        for dcn, rb, p, pw in zip((self.dcn_0, self.dcn_1, self.dcn_2, self.dcn_3),
                                  (self.forward_resblocks_0, self.forward_resblocks_1,
                                   self.forward_resblocks_2, self.forward_resblocks_3),
                                  ps, warped):
            a, offset = dcn(x, p, pw, flow_lv3, offset if cfg.offset_prop else None)
            x = rb(torch.cat([x, a], dim=1))
            new.append(x)
        y = lrelu(self.upsample_post(x))
        return {"p": tuple(new)}, self.conv_last(y) + self._base(lr)

    def _step_dsv(self, state, lr, feat_prop_lv0, x_hr, mk, flow, flow_lv3, fg_lv0, fg_lv3):
        """The DSV step, v18 and v18_cra (:489-574)."""
        cfg = self.cfg
        cra = cfg.variant == "v18_cra"
        if cra:
            mk_lv2, x_hr_lv3 = self._mk_lv2(mk, lr), x_hr[3]
        else:
            x_hr_lv3 = x_hr
        flow_lv0 = (upsample(flow, cfg.scale) * float(cfg.scale)).float()
        hr_state = state["hr"]
        lv3_state = self.downsample(hr_state)
        hr_warped = flow_warp_windowed(hr_state, flow_lv0, cfg.dcn_window_hr)
        lv3_warped = flow_warp_windowed(lv3_state, flow_lv3, cfg.dcn_window)
        feats = torch.chunk(flow_warp_windowed(torch.cat(state["lv"], dim=1), flow_lv3,
                                               cfg.dcn_window), 3, dim=1)

        offset, lvs = None, []
        x = feat_prop_lv0
        for idx, (dcn, rb, f) in enumerate((
                (self.dcn_0, self.forward_resblocks_0, feats[0]),
                (self.dcn_1, self.forward_resblocks_1, feats[1]),
                (self.dcn_2, self.forward_resblocks_2, feats[2]))):
            x = torch.cat([x, f], dim=1)
            aligned, offset = dcn(x, lv3_state, lv3_warped, flow_lv3,
                                  offset if cfg.offset_prop else None)
            x = torch.cat([x, aligned], dim=1)
            if fg_lv0 is not None and idx > 0:
                x = x * fg_lv0
            x = rb(x)
            if cra:
                x = self._cra_blend(x, x_hr[idx], mk_lv2, idx)
            x, carry = self._dsv_chunk(x)
            lvs.append(carry)

        x = lrelu(self.upsample_post(x))
        aligned, _ = self.dcn_3(x, hr_state, hr_warped, flow_lv0,
                                offset if cfg.offset_prop else None)
        y = torch.cat([x, aligned], dim=1)
        if fg_lv3 is not None:
            y = y * fg_lv3
        y = self.forward_resblocks_3(y)
        y, out = self._reconstruct(y, x_hr_lv3, mk, lr)
        return {"hr": y, "lv": tuple(lvs)}, out

    # ---- batch forward (NHWC at the boundary) ----------------------------

    def forward(self, lrs: torch.Tensor, fvs: torch.Tensor, mks: torch.Tensor
                ) -> torch.Tensor:
        """(B, T, h, w, 3) clips -> (B, T, 8h, 8w, 3 or 1) (:677-720)."""
        b, t, h, w, c = lrs.shape
        s = self.cfg.scale

        def nchw(a):
            # (B, T, H, W, C) -> (B, T, C, H, W), NCHW-contiguous. A permuted
            # view of a batch-1 clip is channels-last-dense: cuDNN then keeps
            # channels-last through the recurrent step, and the kernels take
            # NCHW-contiguous operands only
            return a.permute(0, 1, 4, 2, 3).contiguous()

        lrs, fvs, mks = nchw(lrs), nchw(fvs), nchw(mks)
        # flow from each frame to its predecessor, all pairs in one batch
        cur = lrs[:, 1:].reshape(b * (t - 1), c, h, w)
        prev = lrs[:, :-1].reshape(b * (t - 1), c, h, w)
        flows = self.compute_flow(cur, prev).reshape(b, t - 1, 2, h, w)
        # per-frame encoders over all frames at once
        x_lr, x_hr = self.encode_frame(lrs.reshape(b * t, c, h, w),
                                       fvs.reshape(b * t, c, h * s, w * s),
                                       mks.reshape(b * t, 1, h * s, w * s))
        x_lr = x_lr.reshape(b, t, *x_lr.shape[1:])
        x_hr = _tree_map(lambda a: a.reshape(b, t, *a.shape[1:]), x_hr)

        def at(i):
            return _tree_map(lambda a: a[:, i], x_hr)

        state, out = self.step0(lrs[:, 0], x_lr[:, 0], at(0), mks[:, 0])
        outs = [out]
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i in range(1, t):
            args = (state, lrs[:, i], x_lr[:, i], at(i), mks[:, i], flows[:, i - 1])
            if remat:
                state, out = torch.utils.checkpoint.checkpoint(
                    self.step, *args, use_reentrant=False)
            else:
                state, out = self.step(*args)
            outs.append(out)
        return torch.stack(outs, dim=1).permute(0, 1, 3, 4, 2)
