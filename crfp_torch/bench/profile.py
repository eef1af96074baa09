"""Where the time of the streaming slice goes on the GPU.

    python -m crfp_torch.bench.profile

Builds the benchmark's chain (crfp_torch.bench.runtime.build_chain: 1080p,
warp 720^2, mid 32, t=5, bf16) and, after a warm-up, times 4 reps of it
twice in one process: once without the profiler (CUDA events around the
chain) and once under ``torch.profiler``. Prints the device time by kernel
(top 25) and by group (the port's three kernels, convolutions, resizes,
the rest), the device idle share of each chain's wall time, and one JSON
line with the same numbers. Fails without a card, or if the trace holds
no device time.
"""

from __future__ import annotations

import json
import sys
import warnings

import torch

from crfp_torch.bench.runtime import build_chain

# kernel-name substrings -> group, first match wins
_GROUPS = (
    ("kernel A dcn_fwd", ("dcn_fwd_kernel",)),
    ("kernel B flow_warp", ("flow_warp_kernel",)),
    ("kernel C emit", ("emit_kernel",)),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "cutlass", "sm90", "winograd",
                     "implicit", "fprop", "dgrad", "wgrad")),
    ("layout conversion", ("nchwToNhwc", "nhwcToNchw", "transpose", "permute")),
    ("bilinear resize", ("upsample", "interp")),
    ("copy / cat", ("copy", "cat", "Cat")),
)


def _group(name: str) -> str:
    for group, keys in _GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise / other"


def _timed(chain, reps: int) -> float:
    """Wall time of ``chain(reps)`` in microseconds, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chain(reps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3


def _idle_share(busy_us: float, wall_us: float, what: str) -> float:
    """1 - busy/wall, unclamped: a negative share means the busy sum
    over-counts, and is reported as such."""
    if busy_us > wall_us:
        warnings.warn(f"device busy {busy_us:.0f} us exceeds the {what} wall "
                      f"time {wall_us:.0f} us: the busy sum over-counts")
    return 1.0 - busy_us / wall_us


def profile_runtime(reps: int = 4, t: int = 5) -> dict:
    chain = build_chain(preset="1080p", t=t, bf16=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        chain(3)
        torch.cuda.synchronize()
        wall_plain_us = _timed(chain, reps)
        with torch.profiler.profile(activities=acts) as prof:
            wall_prof_us = _timed(chain, reps)
    frames = reps * t
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + us,
                              kernels.get(e.key, (0.0, 0))[1] + e.count)
    busy_us = sum(us for us, _ in kernels.values())
    if busy_us <= 0:
        raise RuntimeError("the profiler trace holds no device time")
    groups = {}
    for name, (us, n) in kernels.items():
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += us
        g[1] += n
    return {
        "device": torch.cuda.get_device_name(0),
        "preset": "1080p", "dtype": "bfloat16",
        "frames": frames,
        "wall_ms_per_frame": wall_plain_us / 1e3 / frames,
        "wall_ms_per_frame_profiled": wall_prof_us / 1e3 / frames,
        "device_busy_ms_per_frame": busy_us / 1e3 / frames,
        # the busy time is the profiled chain's; the unprofiled chain runs
        # the same kernels on the same build
        "device_idle_share": _idle_share(busy_us, wall_plain_us, "unprofiled"),
        "device_idle_share_profiled": _idle_share(busy_us, wall_prof_us, "profiled"),
        "launches_per_frame": sum(n for _, n in kernels.values()) / frames,
        "groups": {g: {"ms_per_frame": us / 1e3 / frames, "launches_per_frame": n / frames,
                       "share_of_busy": us / busy_us}
                   for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])},
        "top_kernels": [
            {"name": name[:120], "ms_per_frame": us / 1e3 / frames,
             "launches_per_frame": n / frames, "group": _group(name)}
            for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]],
    }


def main() -> int:
    r = profile_runtime()
    print(f"[profile] {r['device']} {r['preset']} {r['dtype']}: wall "
          f"{r['wall_ms_per_frame']:.3f} ms/frame unprofiled, "
          f"{r['wall_ms_per_frame_profiled']:.3f} profiled; device busy "
          f"{r['device_busy_ms_per_frame']:.3f} ms/frame; idle share "
          f"{r['device_idle_share']:.3f} unprofiled, "
          f"{r['device_idle_share_profiled']:.3f} profiled; "
          f"{r['launches_per_frame']:.1f} launches/frame")
    for g, v in r["groups"].items():
        print(f"[profile] group {g:22s} {v['ms_per_frame']:.4f} ms/frame "
              f"({v['share_of_busy'] * 100:.1f} % of busy, "
              f"{v['launches_per_frame']:.1f} launches/frame)")
    for k in r["top_kernels"]:
        print(f"[profile] {k['ms_per_frame']:.4f} ms/frame x{k['launches_per_frame']:.1f} "
              f"[{k['group']}] {k['name']}")
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
