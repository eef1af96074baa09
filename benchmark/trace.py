"""The traced window of a ``--trace 1`` run and what the per-layer readers
read from it.

:class:`Tracer` traces two spans of the window, each a fixed number of
units (served steps or train steps). The first records device activity alone,
which costs the host little: the device busy time (the union of every
device interval, kernels, copies and sets) and the window it is a share of
(the span's host-clock length between two device synchronisations) come
from it, and so do the per-layer metrics. The second records host
operations too, which slows the host, and is read only to name what the
host was doing in each device idle gap; a host range named
``bench.window`` marks its start and end on the profiler's clock. Kernel
names are grouped by :data:`GROUPS`, the benchmark's own table, which covers
every kernel of A-F (the general routes' and the anchor table's too).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"

# kernel-name substrings -> group, first match wins
GROUPS = (
    ("kernel A dcn_fwd", ("dcn_fwd_",)),
    ("kernel A/B anchor table", ("anchor_table_kernel",)),
    ("kernel B flow_warp", ("flow_warp_kernel",)),
    ("kernel C emit", ("emit_kernel",)),
    ("kernel D dcn_bwd", ("dcn_bwd_",)),
    ("kernel D flow_warp_bwd", ("flow_warp_bwd_kernel", "cast_bf16_kernel")),
    ("kernel E dcn_fused", ("dcn_fused_",)),
    ("kernel F ssim", ("ssim_kernel",)),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "cutlass", "sm90", "winograd",
                     "implicit", "fprop", "dgrad", "wgrad")),
    ("layout conversion", ("nchwToNhwc", "nhwcToNchw", "transpose", "permute")),
    ("bilinear resize", ("upsample", "interp")),
    ("copy / cat", ("copy", "cat", "Cat")),
)

# the DCN-stage and warp kernels whose roofline ``dcn_roofline.*`` reads
DCN_STAGE_GROUPS = ("kernel A dcn_fwd", "kernel A/B anchor table", "kernel B flow_warp",
                    "kernel E dcn_fused", "kernel D dcn_bwd", "kernel D flow_warp_bwd")


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise / other"


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


@dataclass
class Reading:
    """What a traced window holds. Times in seconds; ``units`` served steps or
    train steps, ``kind`` 'stream' or 'train'; ``counts`` the benchmark's own
    FLOP and byte counts of the traced units (``flops``, ``bound_s``:
    the DCN-stage kernels' least time at the card's peaks; ``flops_untraced``
    and ``untraced_s``: the model FLOPs and the host-clock time of the
    window's units after the traced spans), ``peak_flops`` the
    configuration's."""

    kind: str
    units: int
    window_s: float
    device: list = field(default_factory=list)  # (name, start_s, end_s) clipped to the window
    host: list = field(default_factory=list)  # (name, start_s, end_s), host ranges and ops
    counts: dict = field(default_factory=dict)
    peak_flops: float = 0.0
    gaps: list = field(default_factory=list)  # idle gaps of the host-traced span

    def busy_intervals(self) -> list[tuple[float, float]]:
        spans = sorted((s, e) for _, s, e in self.device if e > s)
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def group_s(self, groups) -> float:
        return sum(e - s for n, s, e in self.device if group_of(n) in groups)

    @property
    def kernels(self) -> int:
        return sum(1 for n, _, _ in self.device if _is_kernel(n))

    def top_ops(self, k: int = 10) -> list[list]:
        tot: dict[str, float] = {}
        for n, s, e in self.device:
            tot[n[:160]] = tot.get(n[:160], 0.0) + (e - s)
        return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Device idle time inside the window, summed by the latest-started
        host operation that covers each gap's middle, the innermost one for
        nested ranges (the window's own range when none does)."""
        busy = self.busy_intervals()
        edges = [(0.0, 0.0)] + busy + [(self.window_s, self.window_s)]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        tot: dict[str, float] = {}
        for (_, e0), (s1, _) in zip(edges, edges[1:]):
            if s1 <= e0:
                continue
            mid = 0.5 * (e0 + s1)
            best = WINDOW
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 256, -1), -1):
                if host[j][2] >= mid:
                    best = host[j][0]
                    break
            tot[best[:160]] = tot.get(best[:160], 0.0) + (s1 - e0)
        return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def _device_events(prof) -> list:
    """(name, start_us, end_us) of every device event of a finished session,
    without the host ranges that the profiler mirrors onto the device."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)
                   or e.name.startswith("Optimizer.")} | {WINDOW}
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == cuda and e.name not in annotations]


class Tracer:
    """Two traced spans of ``units`` units each from unit ``first`` on: the
    device alone, then host and device. Call :meth:`before` and
    :meth:`after` around unit ``i`` of the window; ``sync`` waits for the
    device."""

    def __init__(self, units: int, first: int, sync):
        self.units, self.first, self.sync = units, first, sync
        self.prof = self.host_prof = self.range = None
        self.window_s = 0.0

    @property
    def last(self) -> int:
        """The last unit either span covers; the window's units after it run
        untraced from ``t_done`` on (``mfu.*`` reads their rate)."""
        return self.first + 2 * self.units - 1

    def before(self, i: int) -> None:
        acts = torch.profiler.ProfilerActivity
        if i == self.first:
            self.sync()
            self.prof = torch.profiler.profile(activities=[acts.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif i == self.first + self.units:
            self.host_prof = torch.profiler.profile(activities=[acts.CPU, acts.CUDA])
            self.host_prof.start()
            self.range = torch.autograd.profiler.record_function(WINDOW)
            self.range.__enter__()

    def after(self, i: int) -> None:
        if i == self.first + self.units - 1:
            self.sync()
            self.window_s = time.perf_counter() - self.t0
            self.prof.stop()
        elif i == self.last:
            self.sync()
            self.range.__exit__(None, None, None)
            self.host_prof.stop()
            self.t_done = time.perf_counter()

    def reading(self, kind: str) -> Reading:
        """The first span's :class:`Reading`, with the second's idle gaps."""
        events = _device_events(self.prof)
        if not events:
            raise RuntimeError("the profiler trace holds no device time")
        t0 = min(s for _, s, _ in events)
        r = Reading(kind=kind, units=self.units, window_s=self.window_s,
                    device=[(n, (s - t0) * 1e-6, (e - t0) * 1e-6) for n, s, e in events])
        r.gaps = reduce(self.host_prof, kind, self.units).idle_gaps()
        return r


def reduce(prof, kind: str, units: int) -> Reading:
    """The :class:`Reading` of a finished host-and-device session that
    recorded one ``bench.window`` range, device and host events clipped to
    it; raises if the trace holds no device time."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name == WINDOW and e.device_type != cuda]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' ranges, not 1")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    device, host = [], []
    for name, s, t in _device_events(prof):
        s, t = max(s, w0), min(t, w1)
        if t > s:
            device.append((name, (s - w0) * 1e-6, (t - w0) * 1e-6))
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type != cuda and e.name != WINDOW and t > w0 and s < w1:
            host.append((e.name, (max(s, w0) - w0) * 1e-6, (min(t, w1) - w0) * 1e-6))
    if not device:
        raise RuntimeError("the profiler trace holds no device time")
    return Reading(kind=kind, units=units, window_s=(w1 - w0) * 1e-6, device=device, host=host)
