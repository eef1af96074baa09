"""Kernels G, H and C's conv route: the runtime models' full-resolution
chains around the HR alignment (``crfp_torch/ops/cuda/hr_conv.py``,
``emit.py::emit_frame_conv``).

On the CPU (tier 1): outside autograd the runtime models dispatch the
chains to the dispatchers, whose plain versions run there; under grad, at
other widths and without ``offset_prop`` they call the plain versions
themselves. Both give the bits of the module chains the plain versions
replace (``DCNAlign.forward``, the resblock, ``conv_last`` and kernel C's
emission), in float32, frame and state, for ``CRFPRuntimeV18`` with warp =
frame and with a square ROI on a 1080p-shaped frame (720/1080 of its
height), ``CRFPRuntimeSimple`` v13 and v15, at last_channels 2, 3, 4 and 8
(mid 16, 24, 32, 64). A call under grad never reaches the dispatchers.

On a card (``cuda`` marker, skipped here): each kernel against its plain
version at the deployment cell's shapes (4 x 1080 x 1920, bf16), the
reference cell's (f32) and warp 720 on 1080p, each to a stated tolerance;
and at the other widths it is built for (last_channels 2, 3, 8).

    python -m pytest tests/test_torch_hr_conv.py --noconftest -m cuda -q   # on a card
"""

from __future__ import annotations

import pytest
import torch

import crfp_torch.models.runtime as rt
from crfp_torch.models.config import ModelConfig
from crfp_torch.models.runtime import CRFPRuntimeSimple, CRFPRuntimeV18
from crfp_torch.nn.layers import lrelu
from crfp_torch.ops.cuda import emit, hr_conv
from crfp_torch.ops.shuffle import pixel_shuffle

LR_HW = (18, 32)  # a 1080p-shaped frame of 144 x 256
FV = 16


def _model(variant, mid, warp, device="cpu", dtype=torch.float32, **cfg):
    c = ModelConfig(variant=variant, mid_channels=mid, dcn_window=8, dcn_window_hr=32, **cfg)
    if variant == "v18":
        model = CRFPRuntimeV18(c, warp_size=warp, device="cpu")
    else:
        model = CRFPRuntimeSimple(c, warp_size=warp, device="cpu")
    g = torch.Generator().manual_seed(mid + warp[0])
    with torch.no_grad():  # the zero-initialised heads would leave dcn_3's offsets at the flow
        for conv in (model.dcn_3.dcn_offset.conv, model.dcn_3.dcn_mask.conv):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.3)
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g) * 0.3)
    return model.to(device, dtype).eval()


def _clip(n, batch=1, lr_hw=LR_HW, fv=FV, device="cpu", dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    h, w = lr_hw
    lrs = [torch.rand(batch, h, w, 3, generator=g).to(device, dtype) for _ in range(n)]
    fvs = [torch.rand(batch, fv, fv, 3, generator=g).to(device, dtype) for _ in range(n)]
    return lrs, fvs


def _serve(model, lrs, fvs):
    """(frames, HR states) of encode / step0 / step over the clip."""
    frames, states, state = [], [], None
    for j, (lr, fv) in enumerate(zip(lrs, fvs)):
        x_lr, x_hr = model.encode(lr, fv)
        if j == 0:
            state, out = model.step0(lr, x_lr, x_hr)
        else:
            state, out = model.step(state, lr, lrs[j - 1], x_lr, x_hr)
        frames.append(out.detach())
        states.append(state["hr"].detach())
    return frames, states


def _module_path(model, monkeypatch):
    """Switch ``model`` to the module chains that the plain versions
    replace: ``upsample_post``, ``DCNAlign.forward`` and the resblock over
    the ROI, then leaky_relu, ``conv_last`` and kernel C's emission."""
    def stage(u, hr_state, hr_warped, flow_lv0, offset, third):
        wph, wpw = model.warp_size
        full = lrelu(pixel_shuffle(u, 4))  # lrelu(upsample_post(x)) from its conv's output
        roi = full[:, :, :wph, :wpw]
        aligned, _ = model.dcn_3(roi, hr_state, hr_warped, flow_lv0,
                                 offset if model.cfg.offset_prop else None)
        parts = [roi, aligned] + ([] if third is None else [third])
        return model.forward_resblocks_3(torch.cat(parts, dim=1), full)

    def finish(lv3, conv, lr, roi_hw, emit=None):
        lv3 = lrelu(lv3)
        wph, wpw = roi_hw
        return (lv3[:, :, :wph, :wpw].contiguous(),
                rt.emit_frame(conv(lv3).contiguous(), lr.contiguous(), r=1))

    monkeypatch.setattr(model, "_hr_stage", stage)
    for name in ("emit_frame_conv", "emit_frame_conv_ref"):
        monkeypatch.setattr(rt, name, finish)


def _same(want, got):
    for w_list, g_list in zip(want, got):
        for w, g in zip(w_list, g_list):
            assert g.shape == w.shape and torch.equal(g, w)


# (variant, mid, warp): warp = the frame, and a square ROI on it
CASES = [("v18", 16, (144, 256)), ("v18", 16, (96, 96)), ("v18", 24, (96, 96)),
         ("v18", 32, (144, 256)), ("v18", 32, (96, 96)), ("v18", 64, (96, 96)),
         ("v13", 32, (96, 96)), ("v15", 32, (96, 96)), ("v15", 16, (144, 256))]


@pytest.mark.parametrize("variant,mid,warp", CASES,
                         ids=[f"{v}-mid{m}-{w[0]}x{w[1]}" for v, m, w in CASES])
def test_dispatch_equals_module_path(variant, mid, warp, monkeypatch):
    """Grad off (the dispatchers, whose plain versions run here) and grad on
    (the plain versions) against the module chains: the same bits, every
    frame and every state."""
    torch.manual_seed(0)
    model = _model(variant, mid, warp)
    lrs, fvs = _clip(3)
    assert model.cfg.last_channels in hr_conv.CHANNELS
    with torch.inference_mode():
        got = _serve(model, lrs, fvs)
    with torch.enable_grad():
        got_grad = _serve(model, lrs, fvs)
    _module_path(model, monkeypatch)
    with torch.inference_mode():
        want = _serve(model, lrs, fvs)
    _same(want, got)
    _same(want, got_grad)


@pytest.mark.parametrize("variant", ["v18", "v15"])
def test_without_offset_prop_equals_module_path(variant, monkeypatch):
    """Without ``offset_prop`` dcn_3 has no pre-offset: the plain versions
    run (no kernel takes that head) and give the module chains' bits."""
    model = _model(variant, 32, (96, 96), offset_prop=False)
    lrs, fvs = _clip(3)
    assert not model._hr_kernels()
    with torch.inference_mode():
        got = _serve(model, lrs, fvs)
    _module_path(model, monkeypatch)
    with torch.inference_mode():
        want = _serve(model, lrs, fvs)
    _same(want, got)


def test_grad_keeps_the_module_path(monkeypatch):
    """Under grad the dispatchers are never called, the plain versions are
    instead; outside it each dispatcher is called once a steady step (C's
    conv route every frame)."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    names = ("hr_conv_head", "hr_conv_tail", "emit_frame_conv")
    for name in names + tuple(f"{n}_ref" for n in names):
        monkeypatch.setattr(rt, name, spy(name, getattr(rt, name)))
    model = _model("v18", 16, (96, 96))
    lrs, fvs = _clip(2)
    with torch.enable_grad():
        _serve(model, lrs, fvs)
    assert calls == ["emit_frame_conv_ref", "hr_conv_head_ref", "hr_conv_tail_ref",
                     "emit_frame_conv_ref"]
    calls.clear()
    with torch.no_grad():
        _serve(model, lrs, fvs)
    assert calls == ["emit_frame_conv", "hr_conv_head", "hr_conv_tail", "emit_frame_conv"]


def test_wider_hr_level_keeps_the_module_path(monkeypatch):
    """last_channels outside CHANNELS (mid 40: 5) take the plain versions
    with grad off too."""
    def refuse(*a, **k):
        raise AssertionError("dispatched")

    for name in ("hr_conv_head", "hr_conv_tail", "emit_frame_conv"):
        monkeypatch.setattr(rt, name, refuse)
    model = _model("v18", 40, (96, 96))
    assert model.cfg.last_channels not in hr_conv.CHANNELS
    with torch.no_grad():
        _serve(model, *_clip(2))


def test_dispatchers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, never
    sent to the plain version."""
    model = _model("v18", 32, (96, 96))
    u = torch.zeros(1, 64, 36, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        hr_conv.hr_conv_head(model.dcn_3, u, torch.zeros(1, 4, 96, 96, device="meta"),
                             torch.zeros(1, 2, 96, 96, device="meta"),
                             torch.zeros(1, 64, 24, 24, device="meta"), (96, 96))
    with pytest.raises(ValueError, match="CUDA tensor"):
        hr_conv.hr_conv_tail(model.forward_resblocks_3, u,
                             torch.zeros(1, 4, 96, 96, device="meta"), None, (96, 96))
    with pytest.raises(ValueError, match="emit conv route"):
        emit.emit_frame_conv(torch.zeros(1, 4, 144, 256, device="meta"), model.conv_last,
                             torch.zeros(1, 3, 18, 32, device="meta"), (96, 96))


# ---- on a card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _operands(model, batch, lr_hw, seed):
    """The chains' operands at the third step of a clip on the card, from
    the plain versions (the instance's dispatch switched off): u, hr_state,
    hr_warped, flow_lv0, dcn_2's offset feature, and the LR frame."""
    lrs, fvs = _clip(3, batch, lr_hw, 96, "cuda", next(model.parameters()).dtype, seed)
    ops = {}
    stage = model._hr_stage

    def spy(*a):
        ops.update(zip(("u", "hr_state", "hr_warped", "flow", "offset"), a))
        return stage(*a)

    model._hr_kernels, model._hr_stage = (lambda: False), spy
    with torch.inference_mode():
        state = None
        for j in range(3):
            x_lr, x_hr = model.encode(lrs[j], fvs[j])
            if j == 0:
                state, _ = model.step0(lrs[j], x_lr, x_hr)
            else:
                state, _ = model.step(state, lrs[j], lrs[j - 1], x_lr, x_hr)
    del model._hr_kernels, model._hr_stage
    ops["lr"] = lrs[2].permute(0, 3, 1, 2).contiguous()
    return ops


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _close(kernel, plain, exact, f32):
    """f32: the kernel within 2e-5 of max|ref| of the plain version (the
    plain version's convolutions run cuDNN with TF32 off here; only the
    order of f32 sums differs). bf16: each chain rounds its 3-5 stored
    intermediates to bf16 where the module path does, and a sum taken in
    another order can land one bf16 step away at each and grow through the
    later convolutions, so the kernel's gap to ``exact`` (the plain version
    in f32 on the same bf16 operands and weights) must be at most twice the
    bf16 module chain's gap to it, plus one bf16 step (2^-8) of max|ref|."""
    if f32:
        return _rel(kernel, plain) <= 2e-5
    return _rel(kernel, exact) <= 2 * _rel(plain, exact) + 2 ** -8


def _head(out, flow):
    """G's (offset, mask) as (offset - flow, mask): the residual
    ``mag * tanh(raw)`` that the head computes, held to its own scale (the
    flow passes through exactly and, tens of pixels, would set max|ref|)."""
    off, mask = out
    return off - flow.flip(1), mask


# (variant, dtype, warp) at LR 135 x 240 (1080p): the deployment cell (bf16,
# warp = the frame), the reference cell (f32), warp 720 on 1080p, and v15's
# three-input conv1 there
CARD_CASES = [("v18", torch.bfloat16, (1080, 1920)), ("v18", torch.float32, (1080, 1920)),
              ("v18", torch.bfloat16, (720, 720)), ("v15", torch.float32, (720, 720))]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,dtype,warp", CARD_CASES,
                         ids=["deploy_bf16", "ref_f32", "warp720_bf16", "v15_warp720_f32"])
def test_kernels_match_plain_versions(card, variant, dtype, warp):
    """Each kernel against its plain version on the same operands (seeded
    weights, random dcn_3 heads, 4 viewers, mid 32), to :func:`_close`'s
    tolerance; C's state (leaky_relu alone) bit for bit; H's bits the same
    from an operand of other strides."""
    import copy

    torch.backends.cudnn.allow_tf32 = False
    f32 = dtype == torch.float32
    model = _model(variant, 32, warp, "cuda", dtype)
    exact = copy.deepcopy(model).float()
    ops = _operands(model, 4, (135, 240), 7)
    third = ops["hr_warped"] if variant == "v15" else None
    with torch.inference_mode():
        p = model.dcn_3.upsample.upsample_conv(ops["offset"])
        head_args = (ops["u"], ops["hr_warped"], ops["flow"], p, warp)
        before = hr_conv.head_launches
        got = hr_conv.hr_conv_head(model.dcn_3, *head_args)
        assert hr_conv.head_launches == before + 1
        plain = hr_conv.hr_conv_head_ref(model.dcn_3, *head_args)
        best = hr_conv.hr_conv_head_ref(exact.dcn_3, *(t.float() for t in head_args[:4]), warp)
        for g, w, e in zip(*(_head(t, ops["flow"]) for t in (got, plain, best))):
            assert _close(g, w, e, f32)
        aligned = model.dcn_3.deform(ops["hr_state"], *plain)
        tail_args = (ops["u"], aligned, third, warp)
        before = hr_conv.tail_launches
        lv3 = hr_conv.hr_conv_tail(model.forward_resblocks_3, *tail_args)
        assert hr_conv.tail_launches == before + 1
        # an operand of other strides (the plain DCN's output is one) gives the same bits
        strided = aligned.transpose(2, 3).contiguous().transpose(2, 3)
        assert not strided.is_contiguous()
        assert torch.equal(hr_conv.hr_conv_tail(model.forward_resblocks_3, ops["u"], strided,
                                                third, warp), lv3)
        lv3_plain = hr_conv.hr_conv_tail_ref(model.forward_resblocks_3, *tail_args)
        lv3_best = hr_conv.hr_conv_tail_ref(exact.forward_resblocks_3, ops["u"].float(),
                                            aligned.float(),
                                            None if third is None else third.float(), warp)
        assert _close(lv3, lv3_plain, lv3_best, f32)
        before = emit.conv_launches
        state, frame = emit.emit_frame_conv(lv3_plain, model.conv_last, ops["lr"], warp)
        assert emit.conv_launches == before + 1
        state_plain, frame_plain = emit.emit_frame_conv_ref(lv3_plain, model.conv_last,
                                                            ops["lr"], warp)
        _, frame_best = emit.emit_frame_conv_ref(lv3_plain.float(), exact.conv_last,
                                                 ops["lr"].float(), warp)
        assert torch.equal(state, state_plain)
        assert _close(frame, frame_plain, frame_best, f32)
        torch.cuda.synchronize()


WIDTH_CASES = [(mid, dtype, warp) for mid in (16, 24, 64) for dtype in (torch.float32,
                                                                     torch.bfloat16)
               for warp in ((360, 640), (240, 240))]


@pytest.mark.cuda
@pytest.mark.parametrize("mid,dtype,warp", WIDTH_CASES,
                         ids=[f"mid{m}-{str(d)[6:]}-{w[0]}x{w[1]}" for m, d, w in WIDTH_CASES])
def test_every_width_matches_plain_versions(card, mid, dtype, warp):
    """The other instantiations (last_channels 2, 3, 8) on 2 viewers at LR 45
    x 80 (a 360 x 640 frame), warp = the frame and a 240^2 ROI, to
    :func:`_close`'s tolerance."""
    import copy

    torch.backends.cudnn.allow_tf32 = False
    f32 = dtype == torch.float32
    model = _model("v18", mid, warp, "cuda", dtype)
    exact = copy.deepcopy(model).float()
    ops = _operands(model, 2, (45, 80), 11)
    with torch.inference_mode():
        p = model.dcn_3.upsample.upsample_conv(ops["offset"])
        args = (ops["u"], ops["hr_warped"], ops["flow"], p, warp)
        best = hr_conv.hr_conv_head_ref(exact.dcn_3, *(t.float() for t in args[:4]), warp)
        for g, w, e in zip(*(_head(t, ops["flow"]) for t in (
                hr_conv.hr_conv_head(model.dcn_3, *args),
                hr_conv.hr_conv_head_ref(model.dcn_3, *args), best))):
            assert _close(g, w, e, f32)
        aligned = ops["hr_warped"]  # any (N, L, *warp) operand of the ROI
        lv3 = hr_conv.hr_conv_tail(model.forward_resblocks_3, ops["u"], aligned, None, warp)
        lv3_plain = hr_conv.hr_conv_tail_ref(model.forward_resblocks_3, ops["u"], aligned, None,
                                             warp)
        lv3_best = hr_conv.hr_conv_tail_ref(exact.forward_resblocks_3, ops["u"].float(),
                                            aligned.float(), None, warp)
        assert _close(lv3, lv3_plain, lv3_best, f32)
        state, frame = emit.emit_frame_conv(lv3_plain, model.conv_last, ops["lr"], warp)
        state_plain, frame_plain = emit.emit_frame_conv_ref(lv3_plain, model.conv_last,
                                                            ops["lr"], warp)
        _, frame_best = emit.emit_frame_conv_ref(lv3_plain.float(), exact.conv_last,
                                                 ops["lr"].float(), warp)
        assert torch.equal(state, state_plain)
        assert _close(frame, frame_plain, frame_best, f32)
        torch.cuda.synchronize()
