"""Latency-oriented streaming models (crfp_tpu/models/runtime.py).

``CRFPRuntimeV18`` (:47-278), with ``nofv`` (:85, the reference's
MRCF_simple_v18_nofv: no fovea branch, so no ``encoder_hr`` and no
``conv_tttf`` in its tree), and ``CRFPRuntimeSimple`` (:281-445), the
v13/v15 counterpart, whose only state is the HR feature at the ROI.

The reference benchmark model MRCF_simple_v18: flow is estimated only on
the warp_size/8 crop of the LR frame, the alignment cascade runs on ROI
crops anchored at the top-left, the per-level DSV states live at ROI/4,
and the final resblock stitches the ROI back into the full frame through
a two-input-conv block. The fovea patch is blended into the top-left
corner.

The port computes the logical math in plain NCHW layout (the JAX
package's space-to-depth forms are bit-equivalent TPU layouts,
tests/test_models.py). With ``cfg.dcn_anchor`` dcn_3 and the HR state warp
take per-cell anchored windows on the cell grid of the JAX model's
``hr_s2d`` branch or of its plain one (``cfg.hr_s2d``), as the JAX
deployment configuration runs (bench.py's ``_DEPLOY``). Three kernels run
per frame: kernel A for the four DCNs (dcn_0/1/2 per-tap, dcn_3
shared-tap), kernel B for the HR and lv state warps, kernel C for the
output frame (crfp_torch/ops/cuda). Outside autograd, with
``last_channels`` in :data:`crfp_torch.ops.cuda.hr_conv.CHANNELS`, the
steady step's full-resolution chains take kernels of their own: G for
dcn_3's offset and mask head, H for ``forward_resblocks_3``, and kernel C's
conv route for the finish's leaky_relu and ``conv_last`` (every frame); any
other call takes their plain versions, which call the modules (and kernel C's
row route for the frame).

Public entry points (``encode``, ``step0``, ``step``) take and return NHWC
tensors like the JAX model — frames, encoder features and the state
tensors; inside, everything is NCHW. The NHWC tensors returned are views
of NCHW storage, so handing them back costs no copy.

Spans (``crfp_torch.trace``, on only under a profiler session that records
CPU activity): the entry points are the unit spans ``crfp.serve.encode``,
``crfp.serve.step0`` and ``crfp.serve.step``; inside a step,
``crfp.serve.flow`` (the flow and its two resizes), ``crfp.serve.warp``
(the state warps and downsamples), ``crfp.serve.dcn_0`` to ``dcn_2`` (each
stage's DCN and resblock; the cold start's resblocks), ``crfp.serve.dcn_3``
(``upsample_post``, dcn_3 and its resblock) and ``crfp.serve.finish`` (the
fovea blend, ``conv_last`` and kernel C). Dispatcher spans
``crfp.kernel.G`` and ``crfp.kernel.H`` sit inside ``crfp.serve.dcn_3``.
"""

from __future__ import annotations

import torch
from torch import nn

from crfp_torch.models.config import ModelConfig
from crfp_torch.models.layout import nchw, nchw_or_none, nhwc
from crfp_torch.nn.align import DCNAlign
from crfp_torch.nn.flow import FNet
from crfp_torch.nn.layers import (
    Conv,
    PixelShufflePack,
    PixelUnShufflePackV2,
    ResidualBlockNoBN,
    ResidualBlocksWithInputConv,
    init_parameters,
    lrelu,
)
from crfp_torch.nn.lte import LTESimpleHRSingle, LTESimpleLR
from crfp_torch.ops import resize
from crfp_torch.ops.anchor import hr_warp_geometry
from crfp_torch.ops.cuda import hr_conv
from crfp_torch.ops.cuda.emit import emit_frame, emit_frame_conv, emit_frame_conv_ref
from crfp_torch.ops.cuda.hr_conv import (
    hr_conv_head,
    hr_conv_head_ref,
    hr_conv_tail,
    hr_conv_tail_ref,
)
from crfp_torch.ops.cuda.warp import flow_warp_windowed
from crfp_torch.trace import span


class ResidualBlocksWithInputConvV2(nn.Module):
    """Two input convs: the ROI result of ``conv1`` is patched into the
    top-left corner of ``conv2``'s full-frame result before the residual
    blocks. ``full_channels=None``: the block never sees a larger full
    frame and has no ``conv2`` (as in the JAX tree, where an uncalled
    conv has no parameters)."""

    def __init__(self, roi_channels: int, full_channels: int | None,
                 out_channels: int, num_blocks: int = 1):
        super().__init__()
        self.conv1 = Conv(roi_channels, out_channels)
        if full_channels is not None:
            self.conv2 = Conv(full_channels, out_channels)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", ResidualBlockNoBN(out_channels))

    def forward(self, feat_roi: torch.Tensor,
                feat_full: torch.Tensor | None = None) -> torch.Tensor:
        o1 = self.conv1(feat_roi)
        if feat_full is not None and feat_full.shape[-2:] != feat_roi.shape[-2:]:
            x = self.conv2(feat_full)
            # in place on conv2's fresh output
            x[:, :, : o1.shape[2], : o1.shape[3]] = o1
        else:
            x = o1
        x = lrelu(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class _Runtime(nn.Module):
    """What the runtime models share: the NHWC entry points, the encoders,
    the flow on the warp_size/8 crop and the frame's finish (kernel C)."""

    def _build_front(self, cfg: ModelConfig, warp_size, nofv: bool) -> None:
        """The flow net, the four DCNs, the encoders and the head convs, in
        the registration order that seeds the parameters (as before the
        split into two models); ``nofv`` leaves out the fovea branch."""
        self.cfg, self.nofv = cfg, nofv
        self.warp_size = tuple(warp_size)
        m, last = cfg.mid_channels, cfg.last_channels
        dg, dk, mag = cfg.deform_groups, cfg.dcn_kernel, cfg.max_residue_magnitude
        img = 1 if cfg.y_only else 3  # channels of the LR, fovea and output frames
        self.spynet = FNet(img)
        lv = dict(window=cfg.dcn_window, fused_prep=cfg.dcn_fused)  # 1/4-res stages
        self.dcn_0 = DCNAlign(m, dg, dk, mag, **lv)
        self.dcn_1 = DCNAlign(m, dg, dk, mag, pre_offset=cfg.offset_prop, **lv)
        self.dcn_2 = DCNAlign(m, dg, dk, mag, pre_offset=cfg.offset_prop, **lv)
        # the HR level: shared taps on the ROI at dcn_window_hr
        self.dcn_3 = DCNAlign(last, 1, dk, mag, repeat=True, pre_offset=cfg.offset_prop,
                              interpolate="pixelshuffle", window=cfg.dcn_window_hr,
                              pre_offset_channels=m, anchor=cfg.dcn_anchor)
        self.encoder_lr = LTESimpleLR(m, img)
        if not nofv:
            self.encoder_hr = LTESimpleHRSingle(last, 2 * img)
            self.conv_tttf = Conv(2 * last, last)
        self.conv_last = Conv(last, img)

    # ---- public NHWC entry points -------------------------------------

    def encode(self, lr: torch.Tensor, fv: torch.Tensor | None):
        """lr (N, h, w, c), fv (N, fh, fw, c) -> (x_lr, x_hr), NHWC; c is 3,
        or 1 with ``cfg.y_only``. x_hr is None without a fovea branch."""
        with span("crfp.serve.encode", unit=True):
            x_lr, x_hr = self._encode(nchw(lr), nchw_or_none(fv))
            return nhwc(x_lr), None if x_hr is None else nhwc(x_hr)

    def step0(self, lr, x_lr, x_hr):
        """Cold start. Returns (state, frame (N, 8h, 8w, c)), NHWC."""
        with span("crfp.serve.step0", unit=True):
            state, out = self._step0(nchw(lr), nchw(x_lr), nchw_or_none(x_hr))
            return self._state_nhwc(state), out

    def step(self, state, lr, pre_lr, x_lr, x_hr):
        """Steady state. Returns (state, frame (N, 8h, 8w, c)), NHWC."""
        with span("crfp.serve.step", unit=True):
            state = {k: tuple(nchw(f) for f in v) if k == "lv" else nchw(v)
                     for k, v in state.items()}
            state, out = self._step(state, nchw(lr), nchw(pre_lr), nchw(x_lr),
                                    nchw_or_none(x_hr))
            return self._state_nhwc(state), out

    @staticmethod
    def _state_nhwc(state):
        return {k: tuple(nhwc(f) for f in v) if k == "lv" else nhwc(v)
                for k, v in state.items()}

    # ---- NCHW internals -----------------------------------------------

    def _encode(self, lr, fv):
        if self.nofv:
            return self.encoder_lr(lr), None
        return self.encoder_lr(lr), self.encoder_hr(torch.cat([fv, fv], dim=1))

    def compute_flow(self, lr_cur, lr_prev):
        """Flow from ``lr_cur`` to ``lr_prev`` on their warp_size/8 crops,
        NCHW in and out, like ``CRFP.compute_flow`` (the JAX model's
        ``compute_flow``, which ``step`` runs inside)."""
        wph, wpw = self.warp_size
        return self.spynet(lr_cur[:, :, : wph // 8, : wpw // 8],
                           lr_prev[:, :, : wph // 8, : wpw // 8])

    def _warp_hr(self, hr_state, flow_lv0):
        """The HR state warp at dcn_window_hr, anchored under cfg.dcn_anchor."""
        cfg = self.cfg
        return flow_warp_windowed(hr_state, flow_lv0, cfg.dcn_window_hr,
                                  anchor=hr_warp_geometry(hr_state, cfg.dcn_window_hr,
                                                          cfg.dcn_anchor, cfg.anchor_s2d))

    def _hr_kernels(self) -> bool:
        """Whether the full-resolution chains take kernels G, H and C's conv
        route: outside autograd, at the channel counts they are built for,
        with the offset propagation that dcn_3's head fuses."""
        return (not torch.is_grad_enabled() and self.cfg.offset_prop
                and self.cfg.last_channels in hr_conv.CHANNELS)

    def _hr_stage(self, u, hr_state, hr_warped, flow_lv0, offset, third):
        """dcn_3 and ``forward_resblocks_3`` from ``upsample_post``'s conv
        output ``u`` over the full frame: dcn_3's offset and mask (from
        dcn_2's offset feature ``offset`` under ``offset_prop``), kernel A,
        the resblock (``third``: v15's third input to its conv1, else None).
        Kernels G and H where :meth:`_hr_kernels` holds, else their plain
        versions, which call the modules. Returns lv3 before the fovea
        blend."""
        dcn = self.dcn_3
        head, tail = ((hr_conv_head, hr_conv_tail) if self._hr_kernels()
                      else (hr_conv_head_ref, hr_conv_tail_ref))
        p = dcn.upsample.upsample_conv(offset) if self.cfg.offset_prop else None
        off, mask = head(dcn, u, hr_warped, flow_lv0, p, self.warp_size)
        aligned = dcn.deform(hr_state, off, mask)
        return tail(self.forward_resblocks_3, u, aligned, third, self.warp_size)

    def _finish(self, lv3, x_hr, lr):
        """Blend the fovea into the top-left corner (unless x_hr is None),
        reconstruct, and emit the NHWC frame ``conv_last(lv3) +
        upsample(lr, scale)`` (kernel C). Returns (the new HR state: the
        warp_size ROI of lrelu(lv3), NCHW; the frame, NHWC)."""
        with span("crfp.serve.finish"):
            if x_hr is not None:
                fh, fw = x_hr.shape[-2:]
                blended = self.conv_tttf(torch.cat([lv3[:, :, :fh, :fw], x_hr], dim=1))
                lv3[:, :, :fh, :fw] = blended  # in place on the resblock's fresh output
            if self._hr_kernels():
                return emit_frame_conv(lv3, self.conv_last, lr.contiguous(), self.warp_size)
            return emit_frame_conv_ref(lv3, self.conv_last, lr, self.warp_size, emit=emit_frame)


class CRFPRuntimeV18(_Runtime):
    """Streaming step API: ``encode``, then ``step0`` on the first frame and
    ``step`` on every later one.

    ``nofv``: drop the HR/fovea branch (``encode`` returns x_hr None and
    the frame has no fovea blend; ``fv`` may be None). ``device``: where
    the model lives (default ``cuda``; tests pass ``cpu``). ``seed``:
    seeds the ``torch.Generator`` that initialises the parameters (the JAX
    package's init distributions)."""

    def __init__(self, cfg: ModelConfig, warp_size: tuple[int, int] = (720, 720),
                 *, nofv: bool = False, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        if cfg.variant != "v18":
            raise ValueError(f"CRFPRuntimeV18 needs variant 'v18', got {cfg.variant!r}")
        self._build_front(cfg, warp_size, nofv)
        m, last, keep = cfg.mid_channels, cfg.last_channels, cfg.keep_channels
        st = cfg.state_channels
        # cold-start resblocks (plain) and steady-state stitching resblocks
        self.forward_resblocks_0_ = ResidualBlocksWithInputConv(keep, m)
        self.forward_resblocks_1_ = ResidualBlocksWithInputConv(keep, m)
        self.forward_resblocks_2_ = ResidualBlocksWithInputConv(keep, m)
        self.forward_resblocks_3_ = ResidualBlocksWithInputConv(last, last)
        # stages 0-2 stitch a same-size ROI (concat(feat_temp, aligned) over
        # feat_temp), so their conv2 is never built
        self.forward_resblocks_0 = ResidualBlocksWithInputConvV2(2 * m, None, m)
        self.forward_resblocks_1 = ResidualBlocksWithInputConvV2(2 * m, None, m)
        self.forward_resblocks_2 = ResidualBlocksWithInputConvV2(2 * m, None, m)
        self.forward_resblocks_3 = ResidualBlocksWithInputConvV2(2 * last, last, last)
        self.downsample = PixelUnShufflePackV2(last, m, 4)
        self.upsample = PixelShufflePack(m, keep, 2)
        self.upsample_post = PixelShufflePack(keep, last, 4)
        assert m == keep + st
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def _step0(self, lr, x_lr, x_hr):
        sr = self.cfg.split_ratio
        wph, wpw = self.warp_size
        x = self.upsample(x_lr)  # keep @ 2h x 2w
        lvs = []
        for name, rb in (("crfp.serve.dcn_0", self.forward_resblocks_0_),
                         ("crfp.serve.dcn_1", self.forward_resblocks_1_),
                         ("crfp.serve.dcn_2", self.forward_resblocks_2_)):
            with span(name):
                chunks = torch.chunk(rb(x), 4, dim=1)
                lvs.append(torch.cat(chunks[sr:], dim=1)[:, :, : wph // 4, : wpw // 4]
                           .contiguous())
                x = torch.cat(chunks[:sr], dim=1)
        with span("crfp.serve.dcn_3"):
            x = lrelu(self.upsample_post(x))
            lv3 = self.forward_resblocks_3_(x)
        hr, out = self._finish(lv3, x_hr, lr)
        return {"hr": hr, "lv": tuple(lvs)}, out

    def _step(self, state, lr, pre_lr, x_lr, x_hr):
        cfg = self.cfg
        sr = cfg.split_ratio
        wph, wpw = self.warp_size
        with span("crfp.serve.flow"):
            flow = self.compute_flow(lr, pre_lr)
            # the warp kernels take f32 flow whatever the activations' dtype
            flow_lv3 = (resize.upsample(flow, 2) * 2.0).float()
            flow_lv0 = (resize.upsample(flow, cfg.scale) * float(cfg.scale)).float()
        feat_prop_lv0 = self.upsample(x_lr)

        hr_state = state["hr"]  # last @ ROI
        with span("crfp.serve.warp"):
            hr_warped = self._warp_hr(hr_state, flow_lv0)
            lv3_warped = self.downsample(hr_warped)
            lv3_state = self.downsample(hr_state)
            f = flow_warp_windowed(torch.cat(state["lv"], dim=1), flow_lv3, cfg.dcn_window)
            feats = torch.chunk(f, 3, dim=1)

        roi_lv0 = feat_prop_lv0[:, :, : wph // 4, : wpw // 4]
        offset = None
        lvs = []
        for name, dcn, rb, f in (("crfp.serve.dcn_0", self.dcn_0, self.forward_resblocks_0,
                                  feats[0]),
                                 ("crfp.serve.dcn_1", self.dcn_1, self.forward_resblocks_1,
                                  feats[1]),
                                 ("crfp.serve.dcn_2", self.dcn_2, self.forward_resblocks_2,
                                  feats[2])):
            with span(name):
                feat_temp = torch.cat([roi_lv0, f], dim=1)
                aligned, offset = dcn(feat_temp, lv3_state, lv3_warped, flow_lv3,
                                      offset if cfg.offset_prop else None)
                chunks = torch.chunk(rb(torch.cat([feat_temp, aligned], dim=1), feat_temp),
                                     4, dim=1)
                lvs.append(torch.cat(chunks[sr:], dim=1))

        with span("crfp.serve.dcn_3"):
            lv3 = self._hr_stage(self.upsample_post.upsample_conv(feat_prop_lv0), hr_state,
                                 hr_warped, flow_lv0, offset, None)
        hr, out = self._finish(lv3, x_hr, lr)
        return {"hr": hr, "lv": tuple(lvs)}, out


class CRFPRuntimeSimple(_Runtime):
    """The runtime (warp_size ROI) counterpart of the v13/v15 trunks
    (crfp_tpu/models/runtime.py:281-445): the only state is the HR feature
    at the ROI. Every alignment level's DCN consumes the original upsampled
    ROI ``roi_lv0`` (levels chain only through the offset feature), every
    steady-state block stitches its ROI result into a full-frame conv of
    the upsampled feature, and v15 adds the warped state as a third input.
    Each block's full-frame ``conv2`` is sized by what it takes (the JAX
    divergence note, :293-297). Per steady frame: kernel A 4 (dcn_0/1/2
    per-tap at ``dcn_window``, dcn_3 shared-tap at ``dcn_window_hr``), B 1
    (the HR state at ``dcn_window_hr``), C 1. Same entry points and
    arguments as :class:`CRFPRuntimeV18`."""

    def __init__(self, cfg: ModelConfig, warp_size: tuple[int, int] = (720, 720),
                 *, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        if cfg.variant not in ("v13", "v15"):
            raise ValueError(f"CRFPRuntimeSimple needs variant 'v13' or 'v15', "
                             f"got {cfg.variant!r}")
        self._build_front(cfg, warp_size, nofv=False)
        m, last = cfg.mid_channels, cfg.last_channels
        self.forward_resblocks_0_ = ResidualBlocksWithInputConv(m, m)
        self.forward_resblocks_1_ = ResidualBlocksWithInputConv(m, m)
        self.forward_resblocks_2_ = ResidualBlocksWithInputConv(m, m)
        self.forward_resblocks_3_ = ResidualBlocksWithInputConv(last, last)
        reps = 3 if cfg.variant == "v15" else 2
        self.forward_resblocks_0 = ResidualBlocksWithInputConvV2(reps * m, m, m)
        self.forward_resblocks_1 = ResidualBlocksWithInputConvV2(reps * m, m, m)
        self.forward_resblocks_2 = ResidualBlocksWithInputConvV2(reps * m, m, m)
        self.forward_resblocks_3 = ResidualBlocksWithInputConvV2(reps * last, last, last)
        self.downsample = PixelUnShufflePackV2(last, m, 4)
        self.upsample = PixelShufflePack(m, m, 2)
        self.upsample_post = PixelShufflePack(m, last, 4)
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def _step0(self, lr, x_lr, x_hr):
        x = self.upsample(x_lr)
        for name, rb in (("crfp.serve.dcn_0", self.forward_resblocks_0_),
                         ("crfp.serve.dcn_1", self.forward_resblocks_1_),
                         ("crfp.serve.dcn_2", self.forward_resblocks_2_)):
            with span(name):
                x = rb(x)
        with span("crfp.serve.dcn_3"):
            lv3 = self.forward_resblocks_3_(lrelu(self.upsample_post(x)))
        hr, out = self._finish(lv3, x_hr, lr)
        return {"hr": hr}, out

    def _step(self, state, lr, pre_lr, x_lr, x_hr):
        cfg = self.cfg
        wph, wpw = self.warp_size
        three_way = cfg.variant == "v15"
        with span("crfp.serve.flow"):
            flow = self.compute_flow(lr, pre_lr)
            flow_lv3 = (resize.upsample(flow, 2) * 2.0).float()
            flow_lv0 = (resize.upsample(flow, cfg.scale) * float(cfg.scale)).float()
        feat_prop_lv0 = self.upsample(x_lr)  # mid @ 2h x 2w, full frame

        hr_state = state["hr"]  # last @ ROI
        with span("crfp.serve.warp"):
            hr_warped = self._warp_hr(hr_state, flow_lv0)
            lv3_warped = self.downsample(hr_warped)
            lv3_state = self.downsample(hr_state)

        roi_lv0 = feat_prop_lv0[:, :, : wph // 4, : wpw // 4]
        offset = None
        x = roi_lv0
        for name, dcn, rb in (("crfp.serve.dcn_0", self.dcn_0, self.forward_resblocks_0),
                              ("crfp.serve.dcn_1", self.dcn_1, self.forward_resblocks_1),
                              ("crfp.serve.dcn_2", self.dcn_2, self.forward_resblocks_2)):
            with span(name):
                aligned, offset = dcn(roi_lv0, lv3_state, lv3_warped, flow_lv3,
                                      offset if cfg.offset_prop else None)
                parts = [roi_lv0, aligned] + ([lv3_warped] if three_way else [])
                x = rb(torch.cat(parts, dim=1), feat_prop_lv0)

        with span("crfp.serve.dcn_3"):
            lv3 = self._hr_stage(self.upsample_post.upsample_conv(x), hr_state, hr_warped,
                                 flow_lv0, offset, hr_warped if three_way else None)
        hr, out = self._finish(lv3, x_hr, lr)
        return {"hr": hr}, out
