"""Where the time of the streaming slice and of the train step goes on
the GPU, and of the deployment quality gate's three configurations.

    python -m crfp_torch.bench.profile
    python -m crfp_torch.bench.profile --train   # the train step alone

Streaming (once with ``dcn_fused`` off and once on): builds the
benchmark's chain (crfp_torch.bench.runtime.build_model and build_chain:
1080p, warp 720^2, mid 32, t=5, bf16) and, after a warm-up, times 4 reps
of it twice in one process: once without the profiler (CUDA events around
the chain) and once under ``torch.profiler``. Training: the same for 4
steps of the amp train step at the recipe of record
(crfp_torch.bench.train: B 2, T 7, GT 192, mid 32, windows 8/32, remat),
after 3 warm-up steps. Gate: 8 frames of the 720p clip through the EXACT
runner, the DEPLOY runner and the DEPLOY runner with kernel E, each with
its per-frame zone evaluation (crfp_torch.bench.deploy_gate). Prints, per frame or per step, the device time by
kernel (top 25) and by group (the port's kernels, convolutions, resizes,
the rest), the device idle share of each chain's wall time, and one JSON
line each with the same numbers. Fails without a card, or if a trace
holds no device time.
"""

from __future__ import annotations

import json
import sys
import warnings

import torch

from crfp_torch.bench import train as train_bench
from crfp_torch.bench.runtime import build_chain, build_model

# kernel-name substrings -> group, first match wins
_GROUPS = (
    ("kernel A dcn_fwd", ("dcn_fwd_kernel",)),
    ("kernel B flow_warp", ("flow_warp_kernel",)),
    ("kernel C emit", ("emit_kernel",)),
    # the pre-pass, the tiled kernel and the epilogue of each call
    ("kernel D dcn_bwd", ("dcn_bwd_",)),
    # the scatter and, for bf16, the cast of its f32 accumulator (the
    # accumulator's memset is a "Memset" of the last group)
    ("kernel D flow_warp_bwd", ("flow_warp_bwd_kernel", "cast_bf16_kernel")),
    ("kernel E dcn_fused", ("dcn_fused_kernel",)),
    ("kernel F ssim", ("ssim_kernel",)),
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


def _timed(run) -> float:
    """Wall time of ``run()`` in microseconds, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
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


def capture(run, trace_path: str | None = None):
    """Run ``run()`` under ``torch.profiler`` (host and CUDA activities).
    Returns (profile, wall time of the run in microseconds by CUDA events);
    ``trace_path``: also export the Chrome trace there. No CUDA graph may
    have been captured in the process before: the profiler then loses
    device events."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        wall_us = _timed(run)
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    return prof, wall_us


def _profiled(run, units: int) -> dict:
    """Run ``run()`` (which does ``units`` frames or steps) once without and
    once under the profiler; the per-unit breakdown of the profiled run's
    device time and both idle shares."""
    torch.cuda.synchronize()
    wall_plain_us = _timed(run)
    prof, wall_prof_us = capture(run)
    # user annotations (the optimizer's "Optimizer.step#Adam.step" range)
    # appear on the device timeline too and span kernels counted already
    annotations = {e.name for e in prof.events()
                   if getattr(e, "is_user_annotation", False)
                   or e.name.startswith("Optimizer.")}
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in annotations:
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
        "wall_ms": wall_plain_us / 1e3 / units,
        "wall_ms_profiled": wall_prof_us / 1e3 / units,
        "device_busy_ms": busy_us / 1e3 / units,
        # the busy time is the profiled run's; the unprofiled run launches
        # the same kernels on the same build
        "device_idle_share": _idle_share(busy_us, wall_plain_us, "unprofiled"),
        "device_idle_share_profiled": _idle_share(busy_us, wall_prof_us, "profiled"),
        "launches": sum(n for _, n in kernels.values()) / units,
        "groups": {g: {"ms": us / 1e3 / units, "launches": n / units,
                       "share_of_busy": us / busy_us}
                   for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])},
        "top_kernels": [
            {"name": name[:120], "ms": us / 1e3 / units, "launches": n / units,
             "group": _group(name)}
            for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]],
    }


def profile_runtime(reps: int = 4, t: int = 5, dcn_fused: bool = False) -> dict:
    """Per frame of the bf16 streaming slice (1080p, warp 720^2, mid 32);
    ``dcn_fused``: dcn_0/1/2 through kernel E."""
    chain = build_chain(*build_model(preset="1080p", bf16=True, dcn_fused=dcn_fused), t=t)
    with torch.inference_mode():
        chain(3)
        r = _profiled(lambda: chain(reps), reps * t)
    what = "streaming slice" + (", dcn_fused" if dcn_fused else "")
    return {"device": torch.cuda.get_device_name(0), "what": what,
            "preset": "1080p", "dtype": "bfloat16", "per": "frame", **r}


def profile_gate(frames: int = 8, deploy: bool = True, dcn_fused: bool = True,
                 ckpt: str = "checkpoints/v18_mid32_procedural.npz") -> dict:
    """Per frame of one configuration of the deployment quality gate at
    720p (LR 90x160, mid 32, the trained checkpoint): the streaming batch
    trunk plus the on-device 4-zone evaluation of each frame. The clip is
    streamed once to warm up, then once unprofiled and once profiled."""
    import numpy as np

    from crfp_torch.bench import deploy_gate as dg

    runner = dg.build_runner(ckpt, deploy=deploy, dcn_fused=dcn_fused)
    lr, hr, gaze = dg.gate_clip(np.random.default_rng(42), 50.0, (90, 160), frames)

    def run():
        ev = dg.OnChipZoneEval(dg.FV_SIZE)
        for z, out, gt in dg.stream_clip(runner, lr, hr, gaze):
            ev.update(out, gt, z)

    run()
    r = _profiled(run, frames)
    what = ("gate, DEPLOY bf16 windows 8/32" + (" dcn_fused" if dcn_fused else "")
            if deploy else "gate, EXACT f32 unclamped")
    return {"device": torch.cuda.get_device_name(0), "what": what, "preset": "720p",
            "dtype": "bfloat16" if deploy else "float32", "per": "frame", **r}


def profile_train(steps: int = 4, warmup: int = 3) -> dict:
    """Per step of the amp train step at the recipe of record."""
    rc = train_bench.RECIPE
    opt, step, batches = train_bench.warmed_trainer(warmup, 2 * steps)
    count = iter(range(warmup, len(batches)))

    def run():
        for _ in range(steps):
            i = next(count)
            step(opt, batches[i], i)

    r = _profiled(run, steps)
    return {"device": torch.cuda.get_device_name(0), "what": "train step",
            **rc, "dtype": "bfloat16 (amp)", "per": "step", **r}


def _report(r: dict) -> None:
    per = r["per"]
    print(f"[profile] {r['device']} {r['what']}: wall {r['wall_ms']:.3f} ms/{per} "
          f"unprofiled, {r['wall_ms_profiled']:.3f} profiled; device busy "
          f"{r['device_busy_ms']:.3f} ms/{per}; idle share "
          f"{r['device_idle_share']:.3f} unprofiled, "
          f"{r['device_idle_share_profiled']:.3f} profiled; "
          f"{r['launches']:.1f} launches/{per}")
    for g, v in r["groups"].items():
        print(f"[profile] group {g:22s} {v['ms']:.4f} ms/{per} "
              f"({v['share_of_busy'] * 100:.1f} % of busy, "
              f"{v['launches']:.1f} launches/{per})")
    for k in r["top_kernels"]:
        print(f"[profile] {k['ms']:.4f} ms/{per} x{k['launches']:.1f} "
              f"[{k['group']}] {k['name']}")
    print(json.dumps(r))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true", help="the train step alone")
    args = ap.parse_args(argv)
    if not args.train:
        _report(profile_runtime())
        _report(profile_runtime(dcn_fused=True))
        _report(profile_gate(deploy=False))
        _report(profile_gate(deploy=True, dcn_fused=False))
        _report(profile_gate(deploy=True, dcn_fused=True))
    _report(profile_train())
    return 0


if __name__ == "__main__":
    sys.exit(main())
