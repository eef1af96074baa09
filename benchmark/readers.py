"""The arithmetic of the per-layer metrics over a traced window
(:class:`benchmark.trace.Reading`); each ``benchmark/layer_metrics/<name>.py``
applies one of these to the units it is about. A reader that finds nothing
to read returns None and the metric is left out of the line."""

from __future__ import annotations

from benchmark.trace import DCN_STAGE_GROUPS, Reading


def device_idle(r: Reading) -> float | None:
    """1 - (union of the device intervals) / (the window's span)."""
    return 1.0 - r.busy_s / r.window_s if r.window_s > 0 else None


def kernels_per_unit(r: Reading) -> float | None:
    """Device kernel launches in the trace per served step or train step."""
    return r.kernels / r.units if r.units else None


def conv_ms(r: Reading) -> float | None:
    """Device ms of the convolution group per served step or train step."""
    s = r.group_s(("convolution",))
    return s / r.units * 1e3 if r.units and s > 0 else None


def dcn_roofline(r: Reading) -> float | None:
    """100 * (the DCN-stage and warp calls' least time at the card's
    peaks) / (their kernels' device time in the trace), in %."""
    s = r.group_s(DCN_STAGE_GROUPS)
    bound = r.counts.get("bound_s", 0.0)
    return 100.0 * bound / s if s > 0 and bound > 0 else None


def mfu(r: Reading) -> float | None:
    """100 * model FLOPs / (time * the peak), in %, over the window's units
    that ran after the traced spans, untraced (tracing slows the host)."""
    flops, secs = r.counts.get("flops_untraced", 0.0), r.counts.get("untraced_s", 0.0)
    if flops <= 0 or secs <= 0 or r.peak_flops <= 0:
        return None
    return 100.0 * flops / (secs * r.peak_flops)
