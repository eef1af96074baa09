"""The per-layer readers of the program's spans (``benchmark/spans.py``) on a
synthetic store: units counted by unit spans, each reader's arithmetic, the
other kind's cells, and a store with no spans (or a program with no store),
which reads None. Also the program's real store, filled on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import manifest, spans

MS = 1_000_000  # ns
SERVE = ("host_ms.serve", "dispatch_us.serve")
TRAIN = ("host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train",
         "metrics_host_ms.train")


def _span(name, start_ms, ms):
    return SimpleNamespace(name=name, start=int(start_ms * MS), end=int((start_ms + ms) * MS))


def _serve_store():
    """Three served steps (a step0 and two steps), each with its encode; A,
    B, C and E calls of 20, 40, 10 and 30 us, and a D-warp call no serving
    reader counts."""
    store = []
    for k, unit in enumerate(("crfp.serve.step0", "crfp.serve.step", "crfp.serve.step")):
        t = 100.0 * k
        store += [_span("crfp.serve.encode", t, 1.0), _span(unit, t + 1, 5.0),
                  _span("crfp.serve.flow", t + 1.5, 1.0)]
        store += [_span("crfp.kernel.A", t + 2, 0.020), _span("crfp.kernel.B", t + 3, 0.040),
                  _span("crfp.kernel.C", t + 4, 0.010), _span("crfp.kernel.E", t + 5, 0.030),
                  _span("crfp.kernel.D_warp", t + 5, 5.0)]
    return store


def _train_store():
    """Two train steps of 400 ms; phases of 2 + 1 ms (the optimizer, twice),
    100 ms (forward), 250 ms (backward), 4 ms (metrics)."""
    store = []
    for k in range(2):
        t = 1000.0 * k
        store += [_span("crfp.train.step", t, 400.0), _span("crfp.train.optimizer", t, 2.0),
                  _span("crfp.train.forward", t + 2, 100.0),
                  _span("crfp.train.backward", t + 102, 250.0),
                  _span("crfp.kernel.D", t + 110, 3.0),
                  _span("crfp.train.optimizer", t + 352, 1.0),
                  _span("crfp.train.metrics", t + 353, 4.0)]
    return store


def _read(name, kind, store, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: store)
    return manifest.reader(name)(SimpleNamespace(kind=kind))


@pytest.mark.parametrize("name,want", [("host_ms.serve", 6.0), ("dispatch_us.serve", 25.0)])
def test_serve_readers(name, want, monkeypatch):
    assert _read(name, "stream", _serve_store(), monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [("host_ms.train", 400.0),
                                       ("backward_host_ms.train", 250.0),
                                       ("optimizer_host_ms.train", 3.0),
                                       ("metrics_host_ms.train", 4.0)])
def test_train_readers(name, want, monkeypatch):
    assert _read(name, "train", _train_store(), monkeypatch) == pytest.approx(want)


def test_units_are_the_unit_spans(monkeypatch):
    """A unit is a unit span, not a phase or a kernel: one more step's spans
    change the mean, not the count's denominator by anything else."""
    store = _serve_store()[:8]  # the step0 and its spans alone
    assert _read("host_ms.serve", "stream", store, monkeypatch) == pytest.approx(6.0)
    store = _train_store() + [_span("crfp.train.step", 5000, 100.0)]
    assert _read("host_ms.train", "train", store, monkeypatch) == pytest.approx(300.0)
    assert _read("backward_host_ms.train", "train", store, monkeypatch) == \
        pytest.approx(500.0 / 3)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_no_spans_read_none(name, monkeypatch):
    kind = "stream" if name in SERVE else "train"
    assert _read(name, kind, [], monkeypatch) is None
    # units without the spans a reader needs, or the spans without a unit
    assert _read(name, kind, [_span("crfp.serve.step", 0, 1), _span("crfp.train.step", 0, 1)]
                 if name not in ("host_ms.serve", "host_ms.train") else
                 [_span("crfp.serve.encode", 0, 1), _span("crfp.train.forward", 0, 1)],
                 monkeypatch) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_other_kind_reads_none(name, monkeypatch):
    other = "train" if name in SERVE else "stream"
    store = _serve_store() + _train_store()
    assert _read(name, other, store, monkeypatch) is None


def test_a_program_without_a_store_reads_none(monkeypatch):
    """The parent of the change that added the spans has no
    ``crfp_torch.trace``: ``from crfp_torch import trace`` raises
    ImportError there, and the readers find nothing and do not raise."""
    import sys

    import crfp_torch
    import crfp_torch.trace  # noqa: F401  (so that there is an attribute to take away)

    monkeypatch.delattr(crfp_torch, "trace")
    monkeypatch.setitem(sys.modules, "crfp_torch.trace", None)
    with pytest.raises(ImportError):
        from crfp_torch import trace  # noqa: F401
    assert spans.records() == []
    for name in SERVE + TRAIN:
        kind = "stream" if name in SERVE else "train"
        assert manifest.reader(name)(SimpleNamespace(kind=kind)) is None


def test_reads_the_programs_store():
    """The store a CPU session of the program fills reads as the metrics do."""
    from crfp_torch import trace

    from benchmark import stream
    from benchmark.tests.tiny import tiny_cell

    cell = tiny_cell("ref.streams4_1080p")
    model = cell["family"].stream_program(cell["config"], cell["traffic"],
                                          stream.seeded_weights(cell, 1, "cpu"), "cpu")
    pool = stream.inputs(cell, 1, "cpu")
    lr, fv = pool["lr"][0], pool["fv"][0]
    trace.clear()
    try:
        with torch.inference_mode(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            state, _ = model.step0(lr, *model.encode(lr, fv))
            model.step(state, lr, lr, *model.encode(lr, fv))
        got = manifest.reader("host_ms.serve")(SimpleNamespace(kind="stream"))
        store = spans.records()
    finally:
        trace.clear()
    units = [r for r in store if r.name in spans.SERVE_UNITS]
    assert len(units) == 2
    host = sum(r.end - r.start for r in store if r.name in spans.SERVE_HOST)
    assert got == pytest.approx(host / 2 * 1e-6) and got > 0
