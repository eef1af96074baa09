"""The batch CRFP trunk, v18 (crfp_tpu/models/crfp.py:157-720), the model
the training step differentiates.

``forward`` takes a whole clip: the flow of every (t-1, t) frame pair in
one FNet batch, the two encoders over all B*T frames at once, then
``step0`` on the first frame and a Python loop of ``step`` over the rest,
each step under ``torch.utils.checkpoint`` (non-reentrant) when
``cfg.remat`` is set and autograd records: the JAX package's
``nn.scan(nn.remat(step))``.

This is the DSV branch (v18) in plain layout (``hr_s2d=False``). Unlike
the runtime model it runs on whole frames, with the fovea blended through
its mask, and warps three times per step: the HR state at
``dcn_window_hr`` (:508), ``lv3_state`` at ``dcn_window`` (:526) and the
stacked lv states at ``dcn_window`` (:528), all through kernel B forward
and kernel D backward on the card; the four DCN stages run kernel A
forward and kernel D backward (crfp_torch/ops/cuda), or, with
``cfg.dcn_fused`` and outside autograd, kernel E for dcn_0/1/2.

Module names follow the flax tree, so a flat ``.npz`` checkpoint of the
JAX ``CRFP`` loads strictly through ``crfp_torch.params.from_jax``. Inputs
and outputs are NHWC like the JAX model; inside, everything is NCHW.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from crfp_torch.models.config import ModelConfig
from crfp_torch.nn.align import DCNAlign
from crfp_torch.nn.flow import FNet
from crfp_torch.nn.layers import (
    Conv,
    PixelShufflePack,
    PixelUnShufflePackV2,
    ResidualBlocksWithInputConv,
    init_parameters,
    lrelu,
)
from crfp_torch.nn.lte import LTESimpleHRSingle, LTESimpleLR
from crfp_torch.ops.cuda.warp import flow_warp_windowed
from crfp_torch.ops.resize import resize_bilinear, upsample


class CRFP(nn.Module):
    """``forward(lrs, fvs, mks)``: lrs (B, T, h, w, 3), fvs (B, T, 8h, 8w,
    3), mks (B, T, 8h, 8w, 1) -> (B, T, 8h, 8w, 3), NHWC.

    ``device``: where the model lives (default ``cuda``; tests pass
    ``cpu``). ``seed``: seeds the ``torch.Generator`` that initialises the
    parameters."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        if cfg.variant != "v18":
            raise ValueError(f"the port's CRFP is the v18 trunk, got {cfg.variant!r}")
        if cfg.y_only:
            raise ValueError("the port's CRFP runs RGB frames (y_only=False)")
        self.cfg = cfg
        m, last, keep = cfg.mid_channels, cfg.last_channels, cfg.keep_channels
        dg, dk, mag = cfg.deform_groups, cfg.dcn_kernel, cfg.max_residue_magnitude
        self.spynet = FNet(3)
        lv = dict(window=cfg.dcn_window, fused_prep=cfg.dcn_fused)  # 1/4-res stages
        self.dcn_0 = DCNAlign(m, dg, dk, mag, **lv)
        self.dcn_1 = DCNAlign(m, dg, dk, mag, pre_offset=cfg.offset_prop, **lv)
        self.dcn_2 = DCNAlign(m, dg, dk, mag, pre_offset=cfg.offset_prop, **lv)
        self.dcn_3 = DCNAlign(last, 1, dk, mag, repeat=True,
                              pre_offset=cfg.offset_prop, interpolate="pixelshuffle",
                              window=cfg.dcn_window_hr, pre_offset_channels=m)
        self.encoder_lr = LTESimpleLR(m, 3)
        self.encoder_hr = LTESimpleHRSingle(last, 6)
        self.conv_tttf = Conv(2 * last, last)
        self.conv_last = Conv(last, 3)
        # input: concat(trunk keep, aligned or zero lv3, lv state) = 2*mid
        self.forward_resblocks_0 = ResidualBlocksWithInputConv(2 * m, m)
        self.forward_resblocks_1 = ResidualBlocksWithInputConv(2 * m, m)
        self.forward_resblocks_2 = ResidualBlocksWithInputConv(2 * m, m)
        self.forward_resblocks_3 = ResidualBlocksWithInputConv(2 * last, last)
        self.downsample = PixelUnShufflePackV2(last, m, 4)
        self.upsample = PixelShufflePack(m, keep, 2)
        self.upsample_post = PixelShufflePack(keep, last, 4)
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    # ---- per-frame pieces (NCHW) ----------------------------------------

    def encode_frame(self, lr, fv, mk):
        """Encoders and the fovea blend (:253-278): lr (N, 3, h, w); fv, mk at
        8x. Returns (x_lr, x_hr)."""
        lr_up = upsample(lr, self.cfg.scale)
        mkf = mk.to(lr.dtype)
        blend = fv * mkf + lr_up * (1.0 - mkf)
        return self.encoder_lr(lr), self.encoder_hr(torch.cat([blend, lr_up], dim=1))

    def compute_flow(self, lr_cur, lr_prev):
        return self.spynet(lr_cur, lr_prev)

    def _dsv_chunk(self, x):
        chunks = torch.chunk(x, 4, dim=1)
        sr = self.cfg.split_ratio
        return torch.cat(chunks[:sr], dim=1), torch.cat(chunks[sr:], dim=1)

    def _reconstruct(self, y, x_hr, mk, lr):
        """Fovea texture blend through the mask, conv_last and the bilinear
        x8 base (:336-353). Returns (y, frame)."""
        mkf = mk.to(y.dtype)
        blended = self.conv_tttf(torch.cat([y, x_hr], dim=1))
        y = lrelu(mkf * blended + (1.0 - mkf) * y)
        return y, self.conv_last(y) + upsample(lr, self.cfg.scale)

    def step0(self, lr, x_lr, x_hr, mk):
        """First frame: zero states, no warping (:365-420, DSV branch)."""
        cfg = self.cfg
        n, _, h, w = lr.shape
        z_lv3 = lr.new_zeros(n, cfg.mid_channels, 2 * h, 2 * w)
        z_lv = lr.new_zeros(n, cfg.state_channels, 2 * h, 2 * w)
        z_hr = lr.new_zeros(n, cfg.last_channels, cfg.scale * h, cfg.scale * w)
        x, lvs = self.upsample(x_lr), []
        for rb in (self.forward_resblocks_0, self.forward_resblocks_1,
                   self.forward_resblocks_2):
            x, carry = self._dsv_chunk(rb(torch.cat([x, z_lv3, z_lv], dim=1)))
            lvs.append(carry)
        x = lrelu(self.upsample_post(x))
        y = self.forward_resblocks_3(torch.cat([x, z_hr], dim=1))
        y, out = self._reconstruct(y, x_hr, mk, lr)
        return {"hr": y, "lv": tuple(lvs)}, out

    def step(self, state, lr, x_lr, x_hr, mk, flow, fg=None):
        """One recurrent step (:437-574, DSV branch). flow (N, 2, h, w),
        channels (dx, dy), from this frame to the previous one. fg: optional
        (N, 1, 8h, 8w) regional-computation gate that multiplies the trunk
        features before resblocks 1-2 (at 1/4 size) and 3 (:452-455,
        :545-549, :566-571)."""
        cfg = self.cfg
        fg_lv3 = fg_lv0 = None
        if fg is not None:
            fg_lv3 = fg.to(lr.dtype)
            fg_lv0 = resize_bilinear(fg_lv3, (fg.shape[2] // 4, fg.shape[3] // 4))
        feat_prop_lv0 = self.upsample(x_lr)
        # the warp and DCN kernels take f32 flow whatever the activations' dtype
        flow_lv3 = (upsample(flow, 2) * 2.0).float()
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
            x, carry = self._dsv_chunk(rb(x))
            lvs.append(carry)

        x = lrelu(self.upsample_post(x))
        aligned, _ = self.dcn_3(x, hr_state, hr_warped, flow_lv0,
                                offset if cfg.offset_prop else None)
        y = torch.cat([x, aligned], dim=1)
        if fg_lv3 is not None:
            y = y * fg_lv3
        y = self.forward_resblocks_3(y)
        y, out = self._reconstruct(y, x_hr, mk, lr)
        return {"hr": y, "lv": tuple(lvs)}, out

    # ---- batch forward (NHWC at the boundary) ----------------------------

    def forward(self, lrs: torch.Tensor, fvs: torch.Tensor, mks: torch.Tensor
                ) -> torch.Tensor:
        """(B, T, h, w, 3) clips -> (B, T, 8h, 8w, 3) (:677-720)."""
        b, t, h, w, c = lrs.shape
        s = self.cfg.scale

        def nchw(a):  # (B, T, H, W, C) -> (B, T, C, H, W)
            return a.permute(0, 1, 4, 2, 3)

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
        x_hr = x_hr.reshape(b, t, *x_hr.shape[1:])

        state, out = self.step0(lrs[:, 0], x_lr[:, 0], x_hr[:, 0], mks[:, 0])
        outs = [out]
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i in range(1, t):
            args = (state, lrs[:, i], x_lr[:, i], x_hr[:, i], mks[:, i], flows[:, i - 1])
            if remat:
                state, out = torch.utils.checkpoint.checkpoint(
                    self.step, *args, use_reentrant=False)
            else:
                state, out = self.step(*args)
            outs.append(out)
        return torch.stack(outs, dim=1).permute(0, 1, 3, 4, 2)
