"""Streaming latency harness on the GPU (crfp_tpu/bench/runtime.py:62).

The reference's runtime protocol: synthetic inputs from a seed, batch 1,
``t`` frames per rep (``step0`` then ``t-1`` ``step`` calls, each frame
encoded first), ``repeat_time`` reps of which ``warm_up`` are discarded,
presets 1080p (LR 135x240) / 720p / 512^2, fovea 96^2, warp_size 720^2.

Fused per-frame mode only: frames are enqueued back to back through the
public NHWC entry points and each timed chain ends in
``torch.cuda.synchronize()``; CUDA events time the chain. The best of two
timed chains is reported, as the JAX harness does. Peak memory is
``torch.cuda.max_memory_allocated()`` over the timed chains. Runs on the
card only: without one it raises.

    python -m crfp_torch.bench.runtime [--pairs 10]

times the bf16 1080p slice with ``dcn_fused`` off and on in alternating
pairs (the order flips every pair) within one process and prints every
run, the medians, the quartile distance of the structured runs and the
pairs each side won: the figures a comparison of the two dispatches needs
on a host whose speed drifts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from crfp_torch.models.config import ModelConfig
from crfp_torch.models.runtime import CRFPRuntimeV18

PRESETS = {
    "1080p": {"hr": (1080, 1920), "lr": (135, 240)},
    "720p": {"hr": (720, 1280), "lr": (90, 160)},
    "512": {"hr": (512, 512), "lr": (64, 64)},
}


@dataclasses.dataclass
class BenchResult:
    preset: str
    warp_size: tuple[int, int]
    dtype: str
    sec_per_frame: float
    frames_per_sec: float
    peak_bytes: int
    device: str

    def __str__(self):
        return (f"[{self.preset} warp={self.warp_size} {self.dtype}] "
                f"{self.sec_per_frame * 1e3:.3f} ms/frame = "
                f"{self.frames_per_sec:.2f} fps  |  peak "
                f"{self.peak_bytes / 2**20:.0f} MiB  |  {self.device}")


def build_chain(
    preset: str = "1080p",
    warp_size: tuple[int, int] = (720, 720),
    mid_channels: int = 32,
    t: int = 5,
    fv_hw: tuple[int, int] = (96, 96),
    seed: int = 0,
    dcn_window: int | None = 8,
    dcn_window_hr: int | None = 32,
    bf16: bool = False,
    params_path: str | None = None,
    dcn_fused: bool = False,
):
    """The benchmark's model and inputs on the GPU. Returns
    ``chain(n_reps)``, which enqueues ``n_reps`` reps of ``t`` frames
    (encode + step0, then encode + step) and returns the last frame."""
    if not torch.cuda.is_available():
        raise RuntimeError("the runtime bench measures the GPU; no CUDA device")
    cfg = ModelConfig(mid_channels=mid_channels, dcn_window=dcn_window,
                      dcn_window_hr=dcn_window_hr, dcn_fused=dcn_fused)
    model = CRFPRuntimeV18(cfg, warp_size=warp_size, device="cuda", seed=seed)
    if params_path:
        from crfp_torch.params import load_npz, runtime_params_from_batch

        sd, n_unmapped = runtime_params_from_batch(load_npz(params_path),
                                                   model.state_dict())
        model.load_state_dict(sd)
        print(f"loaded {params_path} ({n_unmapped} runtime-only leaves kept at init)")
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = model.to(dtype).eval()

    lr_h, lr_w = PRESETS[preset]["lr"]
    rng = np.random.default_rng(seed)
    lr = torch.from_numpy(rng.uniform(0, 1, (1, lr_h, lr_w, 3)).astype(np.float32))
    fv = torch.from_numpy(rng.uniform(0, 1, (1, *fv_hw, 3)).astype(np.float32))
    lr, fv = lr.to("cuda", dtype), fv.to("cuda", dtype)

    def chain(n_reps: int):
        out = None
        for _ in range(n_reps):
            x_lr, x_hr = model.encode(lr, fv)
            state, out = model.step0(lr, x_lr, x_hr)
            for _ in range(t - 1):
                x_lr, x_hr = model.encode(lr, fv)
                state, out = model.step(state, lr, lr, x_lr, x_hr)
        return out

    return chain


def run_runtime_bench(
    preset: str = "1080p",
    warp_size: tuple[int, int] = (720, 720),
    mid_channels: int = 32,
    t: int = 5,
    repeat_time: int = 30,
    warm_up: int = 10,
    fv_hw: tuple[int, int] = (96, 96),
    seed: int = 0,
    dcn_window: int | None = 8,
    dcn_window_hr: int | None = 32,
    bf16: bool = False,
    params_path: str | None = None,
    dcn_fused: bool = False,
) -> BenchResult:
    """Time the v18 streaming slice on the current CUDA device.

    The windows default to the deployment configuration (bench.py's
    ``_DEPLOY``: 8 and 32). ``bf16``: weights and activations in bfloat16
    (the kernels accumulate in f32). ``params_path``: a batch-trunk
    ``.npz`` checkpoint adapted by ``crfp_torch.params``. ``dcn_fused``:
    dcn_0/1/2 through kernel E instead of a PyTorch prologue and kernel A."""
    chain = build_chain(preset, warp_size, mid_channels, t, fv_hw, seed,
                        dcn_window, dcn_window_hr, bf16, params_path, dcn_fused)
    with torch.inference_mode():
        chain(max(1, warm_up))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed_reps = max(1, repeat_time - warm_up)
        best_ms = float("inf")
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(timed_reps)
            end.record()
            torch.cuda.synchronize()
            best_ms = min(best_ms, start.elapsed_time(end))
    spf = best_ms / 1e3 / (timed_reps * t)
    return BenchResult(
        preset=preset, warp_size=tuple(warp_size),
        dtype="bfloat16" if bf16 else "float32",
        sec_per_frame=spf, frames_per_sec=1.0 / spf,
        peak_bytes=torch.cuda.max_memory_allocated(),
        device=torch.cuda.get_device_name(0))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=10)
    args = p.parse_args(argv)
    ms = {False: [], True: []}
    for i in range(args.pairs):
        for fused in ((False, True) if i % 2 == 0 else (True, False)):
            res = run_runtime_bench(bf16=True, dcn_fused=fused)
            ms[fused].append(res.sec_per_frame * 1e3)
        print(f"pair {i}: structured {ms[False][-1]:.3f} ms/frame, dcn_fused "
              f"{ms[True][-1]:.3f} ms/frame")
    q1, q3 = np.percentile(ms[False], [25, 75])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "pairs": args.pairs,
        "structured_ms": ms[False], "dcn_fused_ms": ms[True],
        "structured_median_ms": float(np.median(ms[False])),
        "dcn_fused_median_ms": float(np.median(ms[True])),
        "structured_quartile_distance_ms": float(q3 - q1),
        "pairs_won_by_dcn_fused": sum(f < s for s, f in zip(ms[False], ms[True])),
        "pairs_won_by_structured": sum(s < f for s, f in zip(ms[False], ms[True]))}))


if __name__ == "__main__":
    main()
