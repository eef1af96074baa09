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

Public entry points, one frame at a time, NHWC in and out (NCHW inside;
the NHWC tensors returned are views of NCHW storage), as the runtime
models' (``crfp_torch/models/runtime.py``):

- ``encode(lr, fv, mk)`` -> ``(x_lr, x_hr)``: the LR encoder, the fovea
  blended under its full-size mask over the bilinear base (cascaded 2x
  upsamples of lr to the model's scale), the three LTE HR levels and the
  mask pyramid; ``x_hr`` is ``(hr levels, masks)``, two 4-tuples indexed by
  level, None where a level takes none. X8 CRA: ``encode(lr, fv)`` with the
  top-left fovea patch and no mask.
- ``step0(lr, x_lr, x_hr)`` -> ``(state, frame)``: the cold frame.
- ``step(state, lr, pre_lr, x_lr, x_hr)`` -> ``(state, frame)``: SPyNet's
  flow of (lr, pre_lr), a steady frame and its emission. The state is lv3,
  (N, sh, sw, mid).

``forward(lrs, fvs, mks)`` runs a whole clip through those entry points.

On the card SPyNet's flow is replayed from a CUDA graph (its many small
kernels cost the host more than the card), the warps are kernel B with no
clamp (the JAX package gathers), the DCNs kernel A (``dcn_window=None``:
unclamped, the JAX default and its exact gather; else clamped to ±window;
at mid 64 A's O = 64 routes), and each frame's emission
``conv_last_lv3(lrelu(conv_hr_lv3(lv3))) + upsample(lr)`` kernel C. Per steady frame: X8 A 4, B 4, C 1; X4 A 4, B 3,
C 1; the cold frame C 1. Inference only, the stated choice: the entry
points and ``forward`` run under ``torch.no_grad()`` (kernel D takes O = 64
on its general route, but nothing trains these models).

Spans (``crfp_torch.trace``, on only under a profiler session that records
CPU activity): the unit spans ``crfp.serve.encode``, ``crfp.serve.step0``
and ``crfp.serve.step``, the runtime models' names; inside a step
``crfp.serve.flow`` (SPyNet), ``crfp.serve.lv0`` to ``crfp.serve.lv3`` (one
level each: its warp, alignment, resblocks and tail; lv0 also holds the
cascades of the state's 0.5x and the flow's 2x resizes, which every level
reads; the cold frame's levels their resblocks and tails) and ``crfp.serve.finish`` (the emission).
"""

from __future__ import annotations

import torch
from torch import nn

from crfp_torch.models.layout import nchw, nchw_or_none, nhwc
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
from crfp_torch.trace import span


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


class _GraphedFlow:
    """SPyNet's flow replayed from one CUDA graph, for inputs of one shape,
    dtype and device and the weights' storage at capture: its ~500 kernels a
    call are small, and each costs the host more than the card, so in a
    closed loop the card would wait for the host through the whole flow.
    Its buffers are made outside inference mode, so that calls under
    ``torch.no_grad()`` may write into them too."""

    def __init__(self, spynet: SPyNet, lr: torch.Tensor, pre_lr: torch.Tensor):
        self.weights = _storage(spynet)
        with torch.cuda.device(lr.device), torch.inference_mode(False), torch.no_grad():
            self.inputs = (lr.clone(), pre_lr.clone())
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):  # lazy set-up and SPyNet's constants, uncaptured
                spynet(*self.inputs)
            main.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.flow = spynet(*self.inputs)

    def __call__(self, lr: torch.Tensor, pre_lr: torch.Tensor) -> torch.Tensor:
        self.inputs[0].copy_(lr)
        self.inputs[1].copy_(pre_lr)
        self.graph.replay()
        return self.flow.clone()  # the next replay overwrites self.flow


def _storage(module: nn.Module) -> tuple:
    return tuple(t.data_ptr() for t in module.parameters())


def _nhwc_levels(levels):
    return tuple(None if t is None else nhwc(t) for t in levels)


def _nchw_hr(x_hr):
    """``encode``'s x_hr (hr levels, masks) in NCHW."""
    return tuple(tuple(nchw_or_none(t) for t in levels) for levels in x_hr)


class _Pyramid(nn.Module):
    """What the X8 and X4 models share: the NHWC entry points, the modules
    but the upsamples, the encoders, the cold frame and the emission. Subclasses set
    ``SCALE`` and define ``_tail`` (a level's injection and upsample) and
    ``_frame`` (a steady frame)."""

    SCALE = 8

    def _build(self, m, dgs, cra, max_residue_magnitude, dcn_window, ups, device, seed):
        """The modules (``ups``: the levels followed by a PixelShufflePack
        2x, named ``upsample{k}``), initialised from ``seed`` on ``device``."""
        self.mid_channels, self.cra = m, cra
        self.spynet = SPyNet()
        self._flow_graphs = {}
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

    # ---- public NHWC entry points ---------------------------------------

    @torch.no_grad()
    def encode(self, lr, fv, mk=None):
        """lr (N, h, w, 3), fv (N, sh, sw, 3) the full-size fovea frame and mk
        (N, sh, sw, 1) its mask (X8 CRA: fv the top-left fovea patch, no mk)
        -> (x_lr (N, h, w, mid), x_hr), NHWC; x_hr is (hr levels, masks)."""
        if (mk is None) != (self.cra and self.SCALE == 8):
            raise ValueError("MRCF_CRA_x8 takes (lr, fv); the other pyramids take "
                             "(lr, fv, mk)")
        with span("crfp.serve.encode", unit=True):
            x_lr, hrs, mks = self._encode(nchw(lr), nchw(fv), nchw_or_none(mk))
            return nhwc(x_lr), (_nhwc_levels(hrs), _nhwc_levels(mks))

    @torch.no_grad()
    def step0(self, lr, x_lr, x_hr):
        """The cold frame: (state (N, sh, sw, mid), frame (N, sh, sw, 3)), NHWC."""
        with span("crfp.serve.step0", unit=True):
            lr = nchw(lr)
            lv3 = self._frame0(nchw(x_lr), *_nchw_hr(x_hr))
            with span("crfp.serve.finish"):
                out = self._emit(lv3, lr)
            return nhwc(lv3), out

    @torch.no_grad()
    def step(self, state, lr, pre_lr, x_lr, x_hr):
        """A steady frame from the state (lv3) and the previous LR frame:
        (state, frame), NHWC."""
        with span("crfp.serve.step", unit=True):
            lr = nchw(lr)
            with span("crfp.serve.flow"):
                flow = self._flow(lr, nchw(pre_lr))
            lv3 = self._frame(nchw(state), flow, nchw(x_lr), *_nchw_hr(x_hr))
            with span("crfp.serve.finish"):
                out = self._emit(lv3, lr)
            return nhwc(lv3), out

    # ---- NCHW internals --------------------------------------------------

    def _flow(self, lr, pre_lr):
        """SPyNet's flow of (lr, pre_lr); on a card from the graph captured
        for the inputs' shape, dtype and device at its first call (again
        after the weights move)."""
        if not lr.is_cuda:
            return self.spynet(lr, pre_lr)
        key = (lr.shape, lr.dtype, lr.device)
        g = self._flow_graphs.get(key)
        if g is None or g.weights != _storage(self.spynet):
            g = self._flow_graphs[key] = _GraphedFlow(self.spynet, lr, pre_lr)
        return g(lr, pre_lr)

    def _level(self, k, cur, state, warped, flow, hr, mk):
        """Level k of a steady frame: align, the level's resblocks, its tail."""
        aligned = getattr(self, f"align_lv{k}")(cur, state, warped, flow)
        x = getattr(self, f"forward_resblocks_lv{k}")(torch.cat([cur, aligned], dim=1))
        return self._tail(k, x, hr[k], mk[k])

    def _frame0(self, cur, hr, mk):
        """The cold frame (zero states, no flow, no DCN): each level's
        resblocks over concat(cur, zeros), then the level's tail."""
        for k in range(4):
            with span(f"crfp.serve.lv{k}"):
                x = getattr(self, f"forward_resblocks_lv{k}")(
                    torch.cat([cur, torch.zeros_like(cur)], dim=1))
                cur = self._tail(k, x, hr[k], mk[k])
        return cur

    def _mask_blend(self, k, x, x_hr, mk):
        blended = getattr(self, f"conv_tttf_lv{k}")(torch.cat([x, x_hr], dim=1))
        return mk * blended + (1.0 - mk) * x

    def _encode(self, lr, fv, mk):
        """The LR features, the HR pyramid and the mask pyramid of one frame.
        lr (n, 3, h, w); the base is cascaded 2x upsamples to the model's
        scale."""
        w = lr.shape[-1]
        base = lr
        while base.shape[-1] < self.SCALE * w:
            base = upsample(base, 2)
        x_lr = self.encoder_lr(lr)
        if mk is None:  # X8 CRA: the fovea patch beside the crop of the base
            ph, pw = fv.shape[-2:]
            enc_in = torch.cat([fv, base[:, :, :ph, :pw]], dim=1)
            mk_pyr = (None,) * 4
        else:
            mk = mk.to(lr.dtype)
            enc_in = torch.cat([fv * mk + base * (1.0 - mk), base], dim=1)
            mk2 = upsample(mk, 0.5)
            mk_pyr = (None, upsample(mk2, 0.5), mk2, mk)
        return x_lr, (None, *self.encoder_hr(enc_in)), mk_pyr

    def _emit(self, lv3, lr):
        """conv_last_lv3(lrelu(conv_hr_lv3(lv3))) + the bilinear base of lr
        (kernel C), an NHWC frame."""
        y = self.conv_last_lv3(lrelu(self.conv_hr_lv3(lv3)))
        return emit_frame(y.contiguous(), lr.contiguous(), r=1)

    @torch.no_grad()
    def forward(self, lrs, fvs, mks=None):
        """lrs (n, t, h, w, 3), fvs and mks (n, t, sH, sW, 3 / 1) NHWC (X8
        CRA: fvs the top-left fovea patch and no mks) -> frames (n, t, sh,
        sw, 3), s the model's scale: the clip frame by frame through
        :meth:`encode`, :meth:`step0` and :meth:`step`."""
        outs, state = [], None
        for i in range(lrs.shape[1]):
            x_lr, x_hr = self.encode(lrs[:, i], fvs[:, i], None if mks is None else mks[:, i])
            if i == 0:
                state, out = self.step0(lrs[:, i], x_lr, x_hr)
            else:
                state, out = self.step(state, lrs[:, i], lrs[:, i - 1], x_lr, x_hr)
            outs.append(out)
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
        with span("crfp.serve.lv0"):
            flows = [flow0]
            states = [lv3]
            for _ in range(3):
                flows.append(upsample(flows[-1], 2))
                states.insert(0, upsample(states[0], 0.5))
            cur = self._level(0, cur, states[0], _warp(states[0], flow0), flow0, hr, mk)
        for k in (1, 2, 3):
            with span(f"crfp.serve.lv{k}"):
                warped = _warp(states[k], flows[k])
                cur = self._level(k, cur, states[k], warped, flows[k], hr, mk)
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
        with span("crfp.serve.lv0"):
            flow2 = upsample(flow0, 2)
            flows = (flow0, flow0, flow2, upsample(flow2, 2))
            st2 = upsample(lv3, 0.5)
            st1 = upsample(st2, 0.5)
            states = (st1, st1, st2, lv3)
            w0 = _warp(st1, flow0)  # lv0's warped state is lv1's too
            cur = self._level(0, cur, st1, w0, flow0, hr, mk)
        for k in (1, 2, 3):
            with span(f"crfp.serve.lv{k}"):
                warped = w0 if k == 1 else _warp(states[k], flows[k])
                cur = self._level(k, cur, states[k], warped, flows[k], hr, mk)
        return cur
