"""Per-kernel device-time table of the serving slice from a captured trace
(crfp_tpu/bench/trace_table.py, over ``torch.profiler``).

Runs N steady frames (encode + step) of ``CRFPRuntimeV18`` at 1080p, warp
720^2, bf16, windows 8/32 (seeded weights, ``bench/runtime.py::build_model``)
under ``bench/profile.py::capture``, exports the Chrome trace under
``logdir`` and prints each device kernel's total time over N, largest
first. The device lanes are the trace's processes labelled ``GPU <n>``; their
kernel, memcpy and memset events are summed by name (the annotations that
span kernels are not). No CUDA graph may have been captured in the process
before: the profiler then loses device events. Runs on the card only.

    python -m crfp_torch.bench.trace_table --frames 10
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import tempfile
from collections import defaultdict

# device-lane event categories that are device time of their own
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def parse_trace(logdir: str, frames: int, top: int = 40) -> list[tuple[str, float]]:
    """Sum the device lanes' kernel durations per name in the newest Chrome
    trace under ``logdir``; (name, ms per frame), largest first, at most
    ``top`` rows."""
    paths = sorted(glob.glob(os.path.join(logdir, "*.json")) +
                   glob.glob(os.path.join(logdir, "*.json.gz")), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        events = json.load(f)["traceEvents"]
    # torch.profiler names every process after the program and labels the
    # device lanes "GPU <n>" (the host's "CPU")
    dev_pids = {e["pid"] for e in events
                if e.get("ph") == "M" and e.get("name") == "process_labels"
                and str(e.get("args", {}).get("labels", "")).startswith("GPU")}
    tot: dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in dev_pids and e.get("cat") in _DEVICE_CATS:
            tot[e.get("name", "?")] += e.get("dur", 0.0)  # microseconds
    rows = sorted(tot.items(), key=lambda kv: -kv[1])
    return [(n, us / 1e3 / frames) for n, us in rows[:top]]


def run(frames: int = 10, logdir: str | None = None, **bench_kw) -> list[tuple[str, float]]:
    """Capture and print the table. ``bench_kw``: preset, warp_size, bf16
    and the ``ModelConfig`` fields of ``bench/runtime.py::build_model``
    (mid_channels, dcn_window, dcn_window_hr)."""
    import torch

    from crfp_torch.bench import device_of
    from crfp_torch.bench.profile import capture
    from crfp_torch.bench.runtime import build_model

    device_of("cuda")
    logdir = logdir or os.path.join(tempfile.gettempdir(), "crfp_trace_table")
    os.makedirs(logdir, exist_ok=True)
    model, lr, fv = build_model(**{"bf16": True, **bench_kw})

    with torch.inference_mode():
        x_lr, x_hr = model.encode(lr, fv)
        state, _ = model.step0(lr, x_lr, x_hr)

        def steady(n):
            nonlocal state
            for _ in range(n):
                x_lr, x_hr = model.encode(lr, fv)
                state, _ = model.step(state, lr, lr, x_lr, x_hr)

        steady(3)  # warm
        capture(lambda: steady(frames),
                os.path.join(logdir, f"trace_{os.getpid()}.json"))
    rows = parse_trace(logdir, frames)
    total = sum(ms for _, ms in rows)
    print(f"{'ms/frame':>9}  kernel  (top {len(rows)}, sum {total:.3f} ms; "
          f"{torch.cuda.get_device_name(0)})")
    for n, ms in rows:
        print(f"{ms:9.4f}  {n}")
    return rows


def main(argv=None) -> list[tuple[str, float]]:
    import argparse

    from crfp_torch.config import check_tpu_flags

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--preset", default="1080p")
    p.add_argument("--warp", type=int, default=720)
    p.add_argument("--warp_w", type=int, default=None,
                   help="warp width when the ROI is not square "
                        "(full-frame 1080p: --warp 1080 --warp_w 1920)")
    p.add_argument("--mid", type=int, default=32)
    p.add_argument("--dcn_window", type=int, default=8)
    p.add_argument("--dcn_window_hr", type=int, default=32)
    p.add_argument("--hr_s2d", action="store_true")  # a TPU layout: logged, no effect
    p.add_argument("--lv3_s2d", action="store_true")
    p.add_argument("--dcn_anchor", action="store_true")
    p.add_argument("--f32", action="store_true")
    p.add_argument("--logdir", default=None)
    args = p.parse_args(argv)
    check_tpu_flags(args)
    return run(frames=args.frames, logdir=args.logdir, preset=args.preset,
               warp_size=(args.warp, args.warp_w or args.warp), mid_channels=args.mid,
               dcn_window=args.dcn_window, dcn_window_hr=args.dcn_window_hr,
               bf16=not args.f32)


if __name__ == "__main__":
    main()
