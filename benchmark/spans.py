"""The program's own spans (``crfp_torch.trace``), as the per-layer readers
``host_ms.*``, ``dispatch_us.serve`` and ``*_host_ms.train`` read them.

This module is the benchmark's only contact with the program besides the
model families (``benchmark/families/``); it only reads the store of spans that the
program fills while a profiler session that records CPU activity is open.
In a ``--trace 1`` run that is the traced window's second session alone
(host and device, ``benchmark/trace.py``; the first records the device
alone), so the store holds that session's units: its served steps or train
steps, counted here by their unit spans. Durations are host time, from a
span's open to its close. A program without ``crfp_torch.trace``, or a
store without the spans a reader needs, gives None, and the metric is left
out of the line.
"""

from __future__ import annotations

SERVE_UNITS = ("crfp.serve.step0", "crfp.serve.step")
SERVE_HOST = SERVE_UNITS + ("crfp.serve.encode",)
# the dispatchers a served step calls: kernels A, B, C and E
SERVE_KERNELS = ("crfp.kernel.A", "crfp.kernel.B", "crfp.kernel.C", "crfp.kernel.E")
TRAIN_UNITS = ("crfp.train.step",)


def records() -> list:
    """The program's stored spans; none where the program has no store."""
    try:
        from crfp_torch import trace
    except ImportError:  # "cannot import name 'trace'": a program without spans
        return []
    return trace.records()


def ms_per_unit(store, units, names) -> float | None:
    """Host ms of the spans named in ``names`` per unit span (named in
    ``units``) in ``store``."""
    n = sum(r.name in units for r in store)
    durations = [r.end - r.start for r in store if r.name in names]
    return sum(durations) / n * 1e-6 if n and durations else None


def mean_us(store, names) -> float | None:
    """Host us of a span named in ``names``, on average over ``store``."""
    durations = [r.end - r.start for r in store if r.name in names]
    return sum(durations) / len(durations) * 1e-3 if durations else None
