"""``crfp_torch.trace``: the port's spans.

- Off (no profiler session, or one that records CUDA activity alone):
  ``span`` returns the shared no-op and the store stays empty.
- Under a session that records CPU activity: a tiny CPU ``CRFPRuntimeV18``
  gives the serving span tree, a tiny CPU train step its phases in order;
  each span's start agrees with its profiler range's start (one clock); a
  span on another thread takes its parent from that thread; the store's cap
  holds.
- On a card (``cuda`` marker, skipped here): a CUDA-only session records no
  span; a unit span's launch counts equal the dispatcher spans inside it and
  the A/B/C/E/G/H kernels of the same trace (C's conv route among C's), at
  the deployment's configuration.

    python -m pytest tests/test_torch_trace.py --noconftest -m cuda -q   # on a card
"""

from __future__ import annotations

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crfp_torch import trace
from crfp_torch.models.config import ModelConfig
from crfp_torch.models.runtime import CRFPRuntimeV18

MID = 16
LR_HW = (16, 24)
WARP = (64, 64)
FV = 32
SERVE_PHASES = ["crfp.serve.flow", "crfp.serve.warp", "crfp.serve.dcn_0", "crfp.serve.dcn_1",
                "crfp.serve.dcn_2", "crfp.serve.dcn_3", "crfp.serve.finish"]


@pytest.fixture(autouse=True)
def _empty_store():
    trace.clear()
    yield
    trace.clear()


def _cpu_session():
    return profile(activities=[ProfilerActivity.CPU])


def _warm():
    """A range outside any test's reading: the first range of a process or
    a session takes longer to open than the rest."""
    with torch.autograd.profiler.record_function("warm"):
        pass


def _runtime(device="cpu", dtype=torch.float32, batch=1, lr_hw=LR_HW, warp=WARP, fv=FV,
             mid=MID, **cfg):
    model = CRFPRuntimeV18(ModelConfig(mid_channels=mid, **cfg), warp_size=warp,
                           device=device).to(dtype).eval()
    g = torch.Generator().manual_seed(0)
    h, w = lr_hw
    lrs = [torch.rand(batch, h, w, 3, generator=g).to(device, dtype) for _ in range(3)]
    fvs = [torch.rand(batch, fv, fv, 3, generator=g).to(device, dtype) for _ in range(3)]
    return model, lrs, fvs


def _serve(model, lrs, fvs):
    state = None
    with torch.inference_mode():
        for j, (lr, fv) in enumerate(zip(lrs, fvs)):
            x_lr, x_hr = model.encode(lr, fv)
            if j == 0:
                state, _ = model.step0(lr, x_lr, x_hr)
            else:
                state, _ = model.step(state, lr, lrs[j - 1], x_lr, x_hr)


def _children(recs, parent):
    return sorted((r for r in recs if r.parent == parent.id), key=lambda r: r.start)


def test_off_is_the_shared_noop():
    assert trace.span("a") is trace.span("b", {"x": torch.ones(2)}, unit=True)
    with trace.span("a") as s:
        assert s is trace.span("c")
    _serve(*_runtime())
    assert trace.records() == [] and trace.dropped() == 0


def test_serving_span_tree():
    model, lrs, fvs = _runtime()
    with _cpu_session():
        _serve(model, lrs, fvs)
    recs = trace.records()
    roots = sorted((r for r in recs if r.parent is None), key=lambda r: r.start)
    assert [r.name for r in roots] == ["crfp.serve.encode", "crfp.serve.step0"] + [
        "crfp.serve.encode", "crfp.serve.step"] * 2
    step0, step = roots[1], roots[3]
    assert [r.name for r in _children(recs, step0)] == SERVE_PHASES[2:]
    assert [r.name for r in _children(recs, step)] == SERVE_PHASES
    ids = {r.id: r for r in recs}
    for r in recs:
        assert r.start <= r.end and r.thread == threading.get_ident()
        if r.parent is not None:  # nested inside its parent
            p = ids[r.parent]
            assert p.start <= r.start and r.end <= p.end
    # CPU tensors take the plain versions: no dispatcher span, no launch
    assert not any(r.name.startswith("crfp.kernel.") for r in recs)
    assert all(r.counts == {} for r in roots)
    assert all(r.counts is None for r in recs if r.parent is not None)


def test_train_step_phases_in_order():
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.train.loop import TrainConfig, make_optimizer, make_train_step

    model = CRFP(ModelConfig(mid_channels=MID), device="cpu")
    tcfg = TrainConfig(flow_freeze_iters=1)
    opt, step_fn = make_optimizer(model, tcfg), make_train_step(model, tcfg)
    g = torch.Generator().manual_seed(1)
    b, t, h = 1, 2, 8
    hr = torch.rand(b, t, 8 * h, 8 * h, 3, generator=g)
    batch = {"lr": hr.reshape(b, t, h, 8, h, 8, 3).mean((3, 5)), "fv": hr, "hr": hr,
             "mk": torch.ones(b, t, 8 * h, 8 * h, 1)}
    with _cpu_session():
        for step in range(2):
            step_fn(opt, batch, step)
    recs = trace.records()
    steps = sorted((r for r in recs if r.name == "crfp.train.step"), key=lambda r: r.start)
    assert len(steps) == 2 and all(r.parent is None for r in steps)
    for s in steps:
        assert [r.name for r in _children(recs, s)] == [
            "crfp.train.optimizer", "crfp.train.forward", "crfp.train.backward",
            "crfp.train.optimizer", "crfp.train.metrics"]
    assert not any(r.name == "crfp.train.allreduce" for r in recs)


def test_span_on_another_thread_takes_its_own_parent():
    """Autograd runs the CUDA backward on a thread of its own; a span opened
    there nests in that thread's spans, not in the caller's."""
    seen = {}

    def worker():
        with trace.span("crfp.kernel.D"):
            pass
        with trace.span("outer"):
            with trace.span("inner"):
                seen["thread"] = threading.get_ident()

    with _cpu_session():
        with trace.span("crfp.train.backward"):
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    by = {r.name: r for r in trace.records()}
    main = by["crfp.train.backward"]
    assert main.parent is None and main.thread == threading.get_ident()
    assert by["crfp.kernel.D"].parent is None and by["outer"].parent is None
    assert by["inner"].parent == by["outer"].id
    assert {by[n].thread for n in ("crfp.kernel.D", "outer", "inner")} == {seen["thread"]}


def test_spans_are_on_the_profilers_clock():
    """The store's stamps and Kineto's events are both Unix-epoch
    nanoseconds: every stored span brackets its profiler range (its start
    taken just before the range opens, its end just after it closes), and
    the least of those margins is under 50 us at each end. A span whose
    thread the scheduler paused between stamp and range widens its own
    margin only; a clock offset would shift every margin alike."""
    model, lrs, fvs = _runtime()
    _warm()
    with _cpu_session() as prof:
        _warm()
        _serve(model, lrs, fvs)
    ranges: dict[str, list[tuple[int, int]]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("crfp."):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    recs = trace.records()
    assert recs and sum(len(v) for v in ranges.values()) == len(recs)
    lead, lag = [], []
    for r in recs:
        start, end = min(ranges[r.name], key=lambda se: abs(se[0] - r.start))
        lead.append(start - r.start)
        lag.append(r.end - end)
    assert min(lead) >= -5_000 and min(lag) >= -5_000, (min(lead), min(lag))
    assert min(lead) <= 50_000 and min(lag) <= 50_000, (min(lead), min(lag))
    assert sorted(lead)[len(lead) // 2] <= 50_000, sorted(lead)


def test_store_cap_holds(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    with _cpu_session():
        for i in range(12):
            with trace.span(f"s{i}"):
                pass
    assert [r.name for r in trace.records()] == [f"s{i}" for i in range(5)]
    assert trace.dropped() == 7
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_store_under_threads(monkeypatch):
    """More threads than cores close spans at once: the store keeps exactly
    CAP of them, counts the rest, and no id repeats."""
    import sys

    monkeypatch.setattr(trace, "CAP", 500)
    threads, each = 16, 60
    barrier = threading.Barrier(threads)

    def worker():
        barrier.wait(timeout=30)
        for _ in range(each):
            with trace.span("outer"):
                with trace.span("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_session():
            pool = [threading.Thread(target=worker) for _ in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in pool)
    recs = trace.records()
    assert len(recs) == 500 and trace.dropped() == threads * each * 2 - 500
    assert len({r.id for r in recs}) == 500
    ids = {r.id: r for r in recs}
    for r in recs:  # a parent is on the span's own thread
        assert r.parent is None or r.parent not in ids or ids[r.parent].thread == r.thread


def test_args_describe_tensors():
    with _cpu_session():
        with trace.span("a", {"x": torch.ones(2, 3, dtype=torch.bfloat16), "route": "tuned",
                              "anchored": False}):
            pass
        with trace.span("b", {"x": torch.ones(4)}) as s:
            s.note(route="general", branch="general/mma")
    a, b = trace.records()
    assert a.args == {"x": "(2, 3) bfloat16", "route": "tuned", "anchored": False}
    assert b.args == {"x": "(4,) float32", "route": "general", "branch": "general/mma"}
    trace.span("c").note(route="tuned")  # off: nothing kept
    assert len(trace.records()) == 2


# ---- on a card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# kernel-name substring -> (counter, kernels a call)
_KERNELS = {"dcn_fwd_": (("dcn.launches", 2),),
            "anchor_table_kernel": (("dcn.anchor_launches", 1), ("warp.anchor_launches", 1)),
            "flow_warp_kernel": (("warp.launches", 1),),
            "emit_kernel": (("emit.launches", 1),),
            "dcn_fused_": (("dcn_fused.launches", 2),),
            "hr_conv_head_kernel": (("hr_conv.head_launches", 1),),
            "hr_conv_tail_kernel": (("hr_conv.tail_launches", 1),)}
_SPAN_OF = {"dcn.launches": "crfp.kernel.A", "warp.launches": "crfp.kernel.B",
            "emit.launches": "crfp.kernel.C", "dcn_fused.launches": "crfp.kernel.E",
            "hr_conv.head_launches": "crfp.kernel.G", "hr_conv.tail_launches": "crfp.kernel.H"}


@pytest.mark.cuda
def test_cuda_only_session_records_no_span(card):
    model, lrs, fvs = _runtime("cuda")
    _serve(model, lrs, fvs)
    with profile(activities=[ProfilerActivity.CUDA]):
        _serve(model, lrs, fvs)
        torch.cuda.synchronize()
    assert trace.records() == []


@pytest.mark.cuda
def test_unit_counts_match_spans_and_kernels(card):
    """One served step of the deployment (4 viewers, LR 135x240 to 1080x1920,
    bf16, windows 8/32, anchored HR windows, kernel E): the launch counts on
    ``crfp.serve.step`` equal its dispatcher spans, and each count times its
    kernels a call equals that kernel's launches in the trace."""
    model, lrs, fvs = _runtime("cuda", torch.bfloat16, batch=4, lr_hw=(135, 240),
                               warp=(1080, 1920), fv=96, mid=32, dcn_window=8, dcn_window_hr=32,
                               dcn_fused=True, dcn_anchor=True, hr_s2d=True)
    _serve(model, lrs, fvs)
    with torch.inference_mode():
        state, _ = model.step0(lrs[0], *model.encode(lrs[0], fvs[0]))
        x_lr, x_hr = model.encode(lrs[1], fvs[1])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.step(state, lrs[1], lrs[0], x_lr, x_hr)
            torch.cuda.synchronize()
    recs = trace.records()
    (step,) = [r for r in recs if r.name == "crfp.serve.step"]
    counts = step.counts
    inside = [r for r in recs if step.start <= r.start and r.end <= step.end]
    for counter, name in _SPAN_OF.items():
        assert counts.get(counter, 0) == sum(r.name == name for r in inside), counter
    assert counts["dcn.launches"] == 1 and counts["dcn_fused.launches"] == 3
    assert counts["warp.launches"] == 2 and counts["emit.launches"] == 1
    # the full-resolution chains: kernels G and H, and C's conv route
    assert counts["hr_conv.head_launches"] == 1 and counts["hr_conv.tail_launches"] == 1
    assert counts["emit.conv_launches"] == 1
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for key, terms in _KERNELS.items():
        seen = sum(key in n for n in names)
        assert seen == sum(counts.get(c, 0) * k for c, k in terms), (key, seen, counts)
