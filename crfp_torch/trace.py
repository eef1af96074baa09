"""The port's spans, on the profiler's clock.

    from crfp_torch.trace import span

    with span("crfp.serve.step", unit=True):
        ...

A span is on while a ``torch.profiler`` session that records CPU activity
is open (``torch.profiler.profile(activities=[CPU, ...])``, or the older
``torch.autograd.profiler.profile``). Then it opens a
``torch.autograd.profiler.record_function`` range of its name, so that it
sits on the profiler's host timeline beside the device events, and when it
closes it appends a :class:`Span` to an in-memory store (:func:`records`,
:func:`clear`). Otherwise :func:`span` returns one shared no-op object: a
call and one check, no range and no store write. A session that records
CUDA activity alone sees no span, so a device-only trace is the same with
or without them. There is no switch of its own: an operator who opens such
a session around serving or ``python -m crfp_torch.main`` gets the spans.

Which sessions record CPU activity is read where each one starts: importing
this module wraps ``torch.autograd.profiler.profile._start_trace``, which
every session of either API passes through, to note the session's
``use_cpu``. A session opened before the import is not seen.

Stamps are Unix-epoch nanoseconds (``time.time_ns``), the clock of the
profiler's events (Kineto converts its own to it): a span's ``start`` is
taken just before its range opens and its ``end`` just after it closes.
Each span notes its parent, the innermost span open on the same thread
(None on a thread with none open, such as autograd's device thread, which
runs the CUDA backward). A span with ``unit=True`` also notes how much the
dispatchers' launch counters (``crfp_torch/ops/cuda/*.py``, every module
attribute whose name ends in ``launches``) moved over it, keyed
``<module>.<counter>``, nonzero moves only. The store keeps at most
:data:`CAP` spans; spans that close after it is full are counted by
:func:`dropped` and not kept.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Any, NamedTuple

import torch.autograd.profiler as _prof

CAP = 1 << 16
_COUNTER_MODULES = ("dcn", "dcn_fused", "emit", "hr_conv", "ssim", "warp")

_store: list = []
_dropped = 0
_store_lock = threading.Lock()  # autograd's device thread closes spans too
_ids = itertools.count(1)
_local = threading.local()
# the last session started records CPU activity
_cpu_session = False


class Span(NamedTuple):
    id: int
    parent: int | None
    thread: int
    name: str
    args: dict | None
    start: int  # ns since the Unix epoch, the profiler's clock
    end: int
    counts: dict | None  # unit spans: the launch counters' moves


def _watch(start_trace):
    def _start_trace(self):
        global _cpu_session
        _cpu_session = bool(getattr(self, "use_cpu", True))
        return start_trace(self)

    _start_trace.crfp_watch = True
    return _start_trace


if not getattr(_prof.profile._start_trace, "crfp_watch", False):
    _prof.profile._start_trace = _watch(_prof.profile._start_trace)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **args) -> None:
        pass


_OFF = _Off()


def _describe(value: Any):
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        return f"{tuple(value.shape)} {str(value.dtype).removeprefix('torch.')}"
    if value is None or isinstance(value, (str, int, float, bool)):
        return value
    return str(value)


def _launches() -> dict[str, int]:
    out = {}
    for mod in _COUNTER_MODULES:
        m = sys.modules.get(f"crfp_torch.ops.cuda.{mod}")
        if m is not None:
            out.update((f"{mod}.{k}", v) for k, v in vars(m).items()
                       if k.endswith("launches") and isinstance(v, int))
    return out


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Open:
    __slots__ = ("name", "args", "unit", "id", "parent", "start", "before", "range")

    def __init__(self, name: str, args: dict | None, unit: bool):
        self.name, self.unit = name, unit
        self.args = None if args is None else {k: _describe(v) for k, v in args.items()}

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.before = _launches() if self.unit else None
        self.range = _prof.record_function(
            self.name, None if self.args is None else
            ", ".join(f"{k}={v}" for k, v in self.args.items()))
        self.start = time.time_ns()
        self.range.__enter__()
        return self

    def note(self, **args) -> None:
        """Add to the stored span's ``args`` what the call learns once the
        span is open (a dispatcher's route)."""
        self.args = {**(self.args or {}), **{k: _describe(v) for k, v in args.items()}}

    def __exit__(self, *exc):
        global _dropped
        self.range.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        counts = None
        if self.unit:
            before = self.before
            counts = {k: v - before.get(k, 0) for k, v in _launches().items()
                      if v != before.get(k, 0)}
        record = Span(self.id, self.parent, threading.get_ident(), self.name, self.args,
                      self.start, end, counts)
        with _store_lock:
            if len(_store) < CAP:
                _store.append(record)
            else:
                _dropped += 1
        return False


def span(name: str, args: dict | None = None, *, unit: bool = False):
    """A context manager: the span ``name`` while a profiler session that
    records CPU activity is open, else the shared no-op. ``args``: what the
    span notes of its call (tensors as their shape and dtype, other values
    as they are or as text), also on its profiler range; ``unit``: also note
    the launch counters' moves. What ``with`` binds has ``note(**args)``,
    which adds to the stored span's ``args`` (a no-op when off)."""
    if not (_prof._is_profiler_enabled and _cpu_session):
        return _OFF
    return _Open(name, args, unit)


def records() -> list[Span]:
    """The stored spans, in the order they closed (a parent after its
    children)."""
    return list(_store)


def dropped() -> int:
    """Spans not kept since the last :func:`clear`: the store was full."""
    return _dropped


def clear() -> None:
    global _dropped
    with _store_lock:
        _store.clear()
        _dropped = 0
