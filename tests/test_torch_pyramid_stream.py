"""The gen-1 pyramids' serving entry (``encode`` / ``step0`` / ``step``,
``crfp_torch/models/pyramid.py``) on the CPU, f32:

- ``CRFPPyramidX8`` (MRCF_x8, mid 16, dg 16, LR 12x16, 4 frames) on the
  benchmark's seeded weights against the plain reference
  ``benchmark/reference/pyramid.py``, frame by frame: every frame within
  ``FRAME_ATOL`` and the lv3 state within ``STATE_RTOL`` of its largest
  value. Both sides compute the same f32 arithmetic in another order (the
  port's DCN and warp plain versions, the reference's own); the gaps read
  6e-8 and 5e-7 here, so the tolerances leave 100x of room for other CPUs
  and libraries while a reference with the DCN offsets zeroed or the flow
  dropped misses by 1e-3 / 4e-2, over 10x the tolerances;
- ``forward`` equals the loop over the entry points bit for bit, for X8 and
  X4, plain and CRA;
- a steady step makes no tensor from host data (on a card each would wait
  for the queued work), and SPyNet's constants, made once, serve autograd
  after a first call under inference mode;
- the serving spans: the unit spans and the phase spans ``flow``,
  ``lv0``-``lv3`` and ``finish`` under a CPU profiler session.
- On a card (``cuda`` marker, skipped here): a steady bf16 step at mid 64,
  dg 16 moves ``dcn.wide_launches`` by 4 (kernel A's O = 64 routes), also
  in ``dcn.launches``, ``warp.launches`` by 4 and ``emit.launches`` by 1,
  and the trace holds as many of A's, B's and C's kernels; SPyNet's flow
  replayed from its CUDA graph equals SPyNet's own bit for bit.

    python -m pytest tests/test_torch_pyramid_stream.py --noconftest -m cuda -q  # on a card
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import manifest
from benchmark.reference import names, ops
from benchmark.reference.pyramid import PyramidX8
from crfp_torch import trace
from crfp_torch.models.pyramid import CRFPPyramidX4, CRFPPyramidX8
from crfp_torch.nn import flow

torch.set_num_threads(1)

M, DG, T, LR_HW = 16, 16, 4, (12, 16)
FRAME_ATOL = 1e-5
STATE_RTOL = 1e-5
FAMILY = manifest.family("pyramid_x8")


def _clip(scale=8, seed=3, batch=1):
    """(lrs, fvs, mks) (T, N, ...) NHWC: a fovea box under the mask."""
    g = torch.Generator().manual_seed(seed)
    h, w = LR_HW
    lrs = torch.rand(T, batch, h, w, 3, generator=g)
    fvs = torch.rand(T, batch, scale * h, scale * w, 3, generator=g)
    mks = torch.zeros(T, batch, scale * h, scale * w, 1)
    mks[:, :, scale:5 * scale, 2 * scale:8 * scale] = 1.0
    return lrs, fvs, mks


def _weights(seed=11):
    return names.seeded_weights(names.table(PyramidX8(M, DG)), seed, "cpu")


def _port(weights):
    model = CRFPPyramidX8(M, dg_num=DG, device="cpu")
    model.load_state_dict({FAMILY.port_name(k): v for k, v in weights.items()}, strict=True)
    return model.eval()


def _gaps(ref):
    """(frame gap, state gap over max|state|) of every frame of the port
    against the reference model ``ref`` (on the CPU, f32)."""
    port = _port(_weights())
    lrs, fvs, mks = _clip()
    gaps, state, r_state = [], None, None
    with torch.no_grad():
        for i in range(T):
            x_lr, x_hr = port.encode(lrs[i], fvs[i], mks[i])
            lr = lrs[i].permute(0, 3, 1, 2)
            r_in = ref.encode(lr, torch.cat([fvs[i], mks[i]], dim=-1).permute(0, 3, 1, 2))
            if i == 0:
                state, out = port.step0(lrs[i], x_lr, x_hr)
                r_state, r_out = ref.step0(lr, *r_in)
            else:
                state, out = port.step(state, lrs[i], lrs[i - 1], x_lr, x_hr)
                r_state, r_out = ref.step(r_state, lr, lrs[i - 1].permute(0, 3, 1, 2), *r_in)
            gaps.append((float((out.permute(0, 3, 1, 2) - r_out).abs().max()),
                         float((state.permute(0, 3, 1, 2) - r_state).abs().max()
                               / r_state.abs().max())))
    return gaps


def _reference():
    return names.materialize(PyramidX8(M, DG), _weights(), "cpu")


def test_stream_entry_matches_the_plain_reference():
    for frame_gap, state_gap in _gaps(_reference()):
        assert frame_gap <= FRAME_ATOL and state_gap <= STATE_RTOL, (frame_gap, state_gap)


@pytest.mark.parametrize("left_out", ["offsets", "flow"])
def test_a_reference_without_a_mechanism_misses(left_out, monkeypatch):
    ref = _reference()
    if left_out == "offsets":
        dcn = ops.deform_conv2d
        monkeypatch.setattr(ops, "deform_conv2d",
                            lambda x, off, *a, **k: dcn(x, torch.zeros_like(off), *a, **k))
    else:
        monkeypatch.setattr(ref.spynet, "forward",
                            lambda cur, prev: torch.zeros(cur.shape[0], 2, *cur.shape[-2:]))
    steady = _gaps(ref)[1:]
    assert all(f >= 10 * FRAME_ATOL and s >= 10 * STATE_RTOL for f, s in steady), steady


@pytest.mark.parametrize("cls,cra", [(CRFPPyramidX8, False), (CRFPPyramidX8, True),
                                     (CRFPPyramidX4, False), (CRFPPyramidX4, True)],
                         ids=["x8", "x8_cra", "x4", "x4_cra"])
def test_forward_is_the_loop_over_the_entry(cls, cra):
    model = cls(M, cra=cra, dg_num=DG, device="cpu").eval()
    lrs, fvs, mks = _clip(scale=cls.SCALE, batch=2)
    if cls is CRFPPyramidX8 and cra:
        fvs, mks = fvs[:, :, :16, :16], None
    want = model(*(a.transpose(0, 1) for a in (lrs, fvs) + (() if mks is None else (mks,))))
    state = None
    for i in range(T):
        x_lr, x_hr = model.encode(lrs[i], fvs[i], None if mks is None else mks[i])
        if i == 0:
            state, out = model.step0(lrs[i], x_lr, x_hr)
        else:
            state, out = model.step(state, lrs[i], lrs[i - 1], x_lr, x_hr)
        assert torch.equal(out, want[:, i])
    assert state.shape == (2, cls.SCALE * LR_HW[0], cls.SCALE * LR_HW[1], M)


def test_encode_refuses_the_other_variant_s_inputs():
    lrs, fvs, mks = _clip()
    with pytest.raises(ValueError, match="MRCF_CRA_x8"):
        CRFPPyramidX8(M, cra=True, dg_num=DG, device="cpu").encode(lrs[0], fvs[0], mks[0])
    with pytest.raises(ValueError, match="MRCF_CRA_x8"):
        CRFPPyramidX8(M, dg_num=DG, device="cpu").encode(lrs[0], fvs[0])


def test_steady_step_makes_no_tensor_from_host_data(monkeypatch):
    """After the first frame a step makes no tensor from host data: on a card
    each such tensor is a copy that waits for the queued work, so the host
    could not dispatch ahead of the device."""
    model = _port(_weights())
    lrs, fvs, mks = _clip()
    made = []

    def counted(fn):
        return lambda *a, **k: made.append(fn.__name__) or fn(*a, **k)

    with torch.inference_mode():
        x_lr, x_hr = model.encode(lrs[0], fvs[0], mks[0])
        state, _ = model.step0(lrs[0], x_lr, x_hr)
        state, _ = model.step(state, lrs[1], lrs[0], x_lr, x_hr)
        for fn in (torch.tensor, torch.as_tensor, torch.from_numpy):
            monkeypatch.setattr(torch, fn.__name__, counted(fn))
        model.step(state, lrs[2], lrs[1], *model.encode(lrs[2], fvs[2], mks[2]))
    assert made == []


def test_spynet_constants_serve_autograd_after_inference_mode(monkeypatch):
    """SPyNet's constants, made once, are ordinary tensors even when the
    first call ran under ``torch.inference_mode()``."""
    monkeypatch.setattr(flow, "_CONSTANTS", {})
    net = flow.SPyNet()
    a, b = torch.rand(2, 1, 3, 20, 24, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        want = net(a, b)
    a.requires_grad_(True)
    got = net(a, b)
    got.sum().backward()
    assert torch.equal(got.detach(), want) and a.grad is not None


PHASES = ["crfp.serve.flow", "crfp.serve.lv0", "crfp.serve.lv1", "crfp.serve.lv2",
          "crfp.serve.lv3", "crfp.serve.finish"]


def _serve_traced(model, lrs, fvs, mks):
    """Two frames, the second traced under a CPU session (and a CUDA one on a
    card): the stored spans and the trace's device kernels."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if lrs.is_cuda else [])
    with torch.no_grad():
        x_lr, x_hr = model.encode(lrs[0], fvs[0], mks[0])
        state, _ = model.step0(lrs[0], x_lr, x_hr)
        if lrs.is_cuda:
            torch.cuda.synchronize()
        trace.clear()
        with profile(activities=acts) as prof:
            x_lr, x_hr = model.encode(lrs[1], fvs[1], mks[1])
            model.step(state, lrs[1], lrs[0], x_lr, x_hr)
            if lrs.is_cuda:
                torch.cuda.synchronize()
    spans = trace.records()
    trace.clear()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return spans, kernels


def test_serving_spans():
    spans, _ = _serve_traced(_port(_weights()), *_clip())
    by_name = {s.name: s for s in spans}
    step = by_name["crfp.serve.step"]
    assert "crfp.serve.encode" in by_name and step.counts is not None
    phases = [s for s in spans if s.parent == step.id]
    assert [s.name for s in sorted(phases, key=lambda s: s.start)] == PHASES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_steady_step_launches_on_the_card(card):
    model = CRFPPyramidX8(64, dg_num=16, device="cuda").to(torch.bfloat16).eval()
    lrs, fvs, mks = (a.to("cuda", torch.bfloat16) for a in _clip())
    spans, kernels = _serve_traced(model, lrs, fvs, mks)
    step = next(s for s in spans if s.name == "crfp.serve.step")
    assert step.counts == {"dcn.launches": 4, "dcn.wide_launches": 4, "warp.launches": 4,
                           "emit.launches": 1}, step.counts
    # A's pre-pass and tiled kernel a launch, B and C one each, as the trace holds them
    for key, want in (("dcn_fwd_", 8), ("flow_warp_kernel", 4), ("emit_kernel", 1)):
        assert sum(key in n for n in kernels) == want, (key, kernels)
    assert [s.name for s in sorted((s for s in spans if s.parent == step.id),
                                   key=lambda s: s.start)] == PHASES


@pytest.mark.cuda
def test_graphed_flow_equals_spynet_on_the_card(card):
    """The flow replayed from the CUDA graph equals SPyNet's own, frame after
    frame, and weights moved to another dtype are captured anew."""
    model = CRFPPyramidX8(64, dg_num=16, device="cuda").eval()
    lrs = torch.rand(4, 1, 3, *LR_HW, generator=torch.Generator().manual_seed(9)).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        model.to(dtype)
        with torch.inference_mode():
            for i in range(1, 4):
                a, b = lrs[i].to(dtype), lrs[i - 1].to(dtype)
                assert torch.equal(model._flow(a, b), model.spynet(a, b))
    assert len(model._flow_graphs) == 2
