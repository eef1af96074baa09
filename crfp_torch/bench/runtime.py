"""Streaming latency harness on the GPU (crfp_tpu/bench/runtime.py:62).

The reference's runtime protocol: synthetic inputs from a seed, batch 1,
``t`` frames per rep (``step0`` then ``t-1`` ``step`` calls, each frame
encoded first), ``repeat_time`` reps of which ``warm_up`` are discarded,
presets 1080p (LR 135x240) / 720p / 512^2, fovea 96^2, warp_size 720^2.

Two modes, as in the JAX harness:
- fused (the default, the deployment number): frames are enqueued back to
  back through the public NHWC entry points and each timed chain ends in
  ``torch.cuda.synchronize()``; CUDA events time the chain, the best of two
  timed chains is reported, and ``stage_seconds`` is empty;
- per stage (``fused=False``, the reference's flow / encoder / step
  breakdown, CRFP_runtime.py:8654-8662): each rep times ``compute_flow``
  (measured alone; ``step`` runs it again inside), ``encode`` and each
  ``step`` between CUDA events with a device synchronisation at every
  stage boundary; ``stage_seconds`` holds the mean seconds of each stage
  per timed rep (``step``: per call) and ``sec_per_frame`` the reps' whole
  time over their frames, synchronisations included.

Peak memory is ``torch.cuda.max_memory_allocated()`` over the timed reps.
Runs on the card unless the caller passes ``device="cpu"`` (host clock,
no peak memory: no device number); without a card it raises.

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
import time

import numpy as np
import torch

from crfp_torch.bench import device_of
from crfp_torch.models.config import ModelConfig
from crfp_torch.models.runtime import CRFPRuntimeV18

PRESETS = {
    "1080p": {"hr": (1080, 1920), "lr": (135, 240)},
    "720p": {"hr": (720, 1280), "lr": (90, 160)},
    "512": {"hr": (512, 512), "lr": (64, 64)},
}
STAGES = ("flow", "enc", "step")


@dataclasses.dataclass
class BenchResult:
    preset: str
    warp_size: tuple[int, int]
    dtype: str
    sec_per_frame: float
    frames_per_sec: float
    stage_seconds: dict[str, float]
    peak_bytes: int | None
    device: str

    def __str__(self):
        stages = "".join(f"  {k} {v * 1e3:.3f} ms" for k, v in self.stage_seconds.items())
        mem = ("" if self.peak_bytes is None
               else f"  |  peak {self.peak_bytes / 2**20:.0f} MiB")
        return (f"[{self.preset} warp={self.warp_size} {self.dtype}] "
                f"{self.sec_per_frame * 1e3:.3f} ms/frame = "
                f"{self.frames_per_sec:.2f} fps{'  |' + stages if stages else ''}"
                f"{mem}  |  {self.device}")


def build_model(
    preset: str = "1080p",
    warp_size: tuple[int, int] = (720, 720),
    mid_channels: int = 32,
    fv_hw: tuple[int, int] = (96, 96),
    seed: int = 0,
    dcn_window: int | None = 8,
    dcn_window_hr: int | None = 32,
    bf16: bool = False,
    params_path: str | None = None,
    dcn_fused: bool = False,
    device: str | torch.device = "cuda",
    dcn_anchor: bool = False,
    hr_s2d: bool = False,
):
    """The benchmark's model (eval mode) and its NHWC inputs ``lr``, ``fv``
    on ``device``. ``params_path``: a batch-trunk checkpoint in any format
    ``load_params`` reads, adapted onto the runtime trunk. ``dcn_anchor``
    and ``hr_s2d``: anchored HR windows on the cell grid of the JAX
    package's s2d(4) tail or of its plain one (``ModelConfig``)."""
    device = device_of(device)
    cfg = ModelConfig(mid_channels=mid_channels, dcn_window=dcn_window,
                      dcn_window_hr=dcn_window_hr, dcn_fused=dcn_fused,
                      dcn_anchor=dcn_anchor, hr_s2d=hr_s2d)
    model = CRFPRuntimeV18(cfg, warp_size=warp_size, device=device, seed=seed)
    if params_path:
        from crfp_torch.params import runtime_params_from_batch
        from crfp_torch.utils.params_io import load_params

        sd, n_unmapped = runtime_params_from_batch(load_params(params_path),
                                                   model.state_dict())
        model.load_state_dict(sd)
        print(f"loaded {params_path} ({n_unmapped} runtime-only leaves kept at init)")
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = model.to(dtype).eval()

    lr_h, lr_w = PRESETS[preset]["lr"]
    rng = np.random.default_rng(seed)
    lr = torch.from_numpy(rng.uniform(0, 1, (1, lr_h, lr_w, 3)).astype(np.float32))
    fv = torch.from_numpy(rng.uniform(0, 1, (1, *fv_hw, 3)).astype(np.float32))
    return model, lr.to(device, dtype), fv.to(device, dtype)


def build_chain(model, lr, fv, t: int = 5):
    """Returns ``chain(n_reps)``, which enqueues ``n_reps`` reps of ``t``
    frames (encode + step0, then encode + step) of :func:`build_model`'s
    ``model`` on its inputs and returns the last frame."""

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


def _timed(device: torch.device, fn, *args):
    """(fn(*args), seconds): CUDA events around the call and a device
    synchronisation after it on the card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end) / 1e3


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
    fused: bool = True,
    device: str | torch.device = "cuda",
    dcn_anchor: bool = False,
    hr_s2d: bool = False,
) -> BenchResult:
    """Time the v18 streaming slice (see the module note for the two modes).

    The windows default to the deployment configuration (bench.py's
    ``_DEPLOY``: 8 and 32). ``bf16``: weights and activations in bfloat16
    (the kernels accumulate in f32). ``params_path``: a batch-trunk
    checkpoint adapted by ``crfp_torch.params.runtime_params_from_batch``.
    ``dcn_fused``: dcn_0/1/2 through kernel E instead of a PyTorch
    prologue and kernel A. ``dcn_anchor``, ``hr_s2d``: as
    crfp_tpu/bench/runtime.py:76-92, anchored HR windows and the selector
    of their cell grid (:func:`build_model`)."""
    device = device_of(device)
    model, lr, fv = build_model(preset, warp_size, mid_channels, fv_hw, seed, dcn_window,
                                dcn_window_hr, bf16, params_path, dcn_fused, device,
                                dcn_anchor, hr_s2d)
    on_card = device.type == "cuda"
    timed_reps = max(1, repeat_time - warm_up)
    stages: dict[str, float] = {}
    with torch.inference_mode():
        if fused:
            chain = build_chain(model, lr, fv, t)
            _timed(device, chain, max(1, warm_up))
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            total = min(_timed(device, chain, timed_reps)[1] for _ in range(2))
        else:
            lr_nchw = lr.permute(0, 3, 1, 2).contiguous()  # compute_flow's layout
            sums = dict.fromkeys(STAGES, 0.0)
            total = 0.0

            def rep():
                _, t_flow = _timed(device, model.compute_flow, lr_nchw, lr_nchw)
                (x_lr, x_hr), t_enc = _timed(device, model.encode, lr, fv)
                state, _ = model.step0(lr, x_lr, x_hr)
                t_step = 0.0
                for _ in range(t - 1):
                    (state, _), dt = _timed(device, model.step, state, lr, lr, x_lr, x_hr)
                    t_step += dt
                return t_flow, t_enc, t_step / max(t - 1, 1)

            for i in range(timed_reps + warm_up):
                if i == warm_up and on_card:
                    torch.cuda.reset_peak_memory_stats(device)
                per, dt = _timed(device, rep)
                if i >= warm_up:
                    total += dt
                    for k, v in zip(STAGES, per):
                        sums[k] += v
            stages = {k: v / timed_reps for k, v in sums.items()}
    spf = total / (timed_reps * t)
    return BenchResult(
        preset=preset, warp_size=tuple(warp_size),
        dtype="bfloat16" if bf16 else "float32",
        sec_per_frame=spf, frames_per_sec=1.0 / spf, stage_seconds=stages,
        peak_bytes=torch.cuda.max_memory_allocated(device) if on_card else None,
        device=torch.cuda.get_device_name(device) if on_card else "cpu")


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
