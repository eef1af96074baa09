"""Smoke run of the PyTorch/CUDA port (crfp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:
1. print the card (nvidia-smi name, power limit) and build the kernels of
   crfp_torch/csrc with nvcc (sm_90a), all sources in parallel;
2. hold each kernel against its plain PyTorch version on the card at the
   main-path shapes (1080p, warp 720^2, mid 32): f32 with TF32 off, A to
   1e-4 abs, B and C to 1e-5 abs; bf16 inputs against the f32 plain
   version to 2e-2 of max|ref|; time kernel, plain version and, where one
   PyTorch call computes the same function, that call;
3. drive the slice through its entry points (encode, step0, step) over 5
   frames at 1080p / warp 720^2 / mid 32 with checkpoints/v18_mid32_struct.npz,
   once through the kernels and once through the plain versions, both in
   f32; every frame must agree to >= 80 dB PSNR and max|d| <= 1e-3, and
   the launch counters must show A 4, B 2, C 1 per steady-state frame;
4. time the bf16 slice with crfp_torch.bench.runtime.run_runtime_bench;
5. print one {"kernels": [...]} line and, last, the {"ok": true, ...} line.

Imports nothing of JAX or of crfp_tpu.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "checkpoints" / "v18_mid32_struct.npz"

# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; bf16 tensor
# cores 989 TFLOP/s; f32 outside the tensor cores 67 TFLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

LR_HW, HR_HW, WARP, FV, MID = (135, 240), (1080, 1920), (720, 720), 96, 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(inputs, outputs, flops: float, dtype: str) -> tuple[float, str, float, float]:
    """(bound ms, 'bytes'|'operations', bytes ms, operations ms): each input
    read once and each output written once at the memory rate, against the
    operations at the peak rate of the inputs' type."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs)
                 if t is not None)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        t_bytes, t_ops


@contextlib.contextmanager
def plain_kernels():
    """Route the model's three kernel call sites to the plain versions
    (the model calls the dispatchers by these module-level names)."""
    import crfp_torch.models.runtime as rt
    import crfp_torch.nn.align as al
    from crfp_torch.ops.cuda.emit import emit_frame_ref
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    saved = (al.deform_conv2d_windowed, rt.flow_warp_windowed, rt.emit_frame)
    al.deform_conv2d_windowed = deform_conv2d_windowed_ref
    rt.flow_warp_windowed = flow_warp_windowed_ref
    rt.emit_frame = emit_frame_ref
    try:
        yield
    finally:
        al.deform_conv2d_windowed, rt.flow_warp_windowed, rt.emit_frame = saved


def phase_build():
    from crfp_torch.ops.cuda import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s "
          f"({_build.find_nvcc()})")
    for name in sorted(libs):
        log = _build.BUILD_DIR / f"{name}.log"
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(gen):
    """Phase 2. Returns the per-kernel records (without launches)."""
    import torch
    import torch.nn.functional as F

    from crfp_torch.ops.cuda import dcn, emit, warp
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    dev = "cuda"

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    q = (WARP[0] // 4, WARP[1] // 4)
    modes = []  # one record per (kernel, main-path call shape)

    def record(kernel, mode, calls, err, bf16_rel, k_ms, p_ms, lib_ms, bnd):
        b_ms, b_by, t_bytes, t_ops = bnd
        print(f"[kernel] {kernel:9s} {mode:34s} f32 max|d| {err:.3e}  bf16 "
              f"max|d|/max|ref| {bf16_rel:.3e}  kernel {k_ms:.4f} ms  plain "
              f"{p_ms:.4f} ms  library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
              f"{b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f}, ops {t_ops:.4f})")
        modes.append(dict(kernel=kernel, mode=mode, calls_per_frame=calls,
                          max_abs_err=err, bf16_rel_err=bf16_rel, ms=k_ms,
                          plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by))

    def smooth(c, hw, amp):
        """A flow-like field: std ``amp``, varying over ~32 pixels."""
        lo = torch.randn(1, c, max(2, hw[0] // 32), max(2, hw[1] // 32), generator=gen)
        return F.interpolate((lo * amp).to(dev), size=hw, mode="bilinear",
                             align_corners=False).contiguous()

    def check(kernel, mode, tol, got, ref):
        err = float((got - ref).abs().max())
        if not err <= tol:
            fail(f"{kernel} {mode}: f32 max|d| {err} > {tol}")
        return err

    def check_bf16(kernel, mode, got, ref):
        rel = float((got.float() - ref).abs().max() / ref.abs().max())
        if not rel <= 2e-2:
            fail(f"{kernel} {mode}: bf16 error {rel} of max|ref| > 2e-2")
        return rel

    # Correctness is checked on white-noise offsets/flows (every sample
    # lands somewhere else) and on smooth flow-like ones; times are taken
    # on the smooth ones, which is what the model feeds the kernels.

    # ---- A: per-tap (dcn_0/1/2) and shared-tap (dcn_3) ----------------
    for mode, (c, o, g, hw, d, shared) in {
        "per-tap G=8 D=8 (1,32,180,180)": (MID, MID, 8, q, 8, False),
        "shared G=1 D=32 (1,4,720,720)": (MID // 8, MID // 8, 1, WARP, 32, True),
    }.items():
        taps = 1 if shared else 9
        x = randn(1, c, *hw)
        noisy = randn(1, g * taps * 2, *hw, std=0.75 * d)
        off = (smooth(2, hw, d).repeat(1, g * taps, 1, 1)
               + randn(1, g * taps * 2, *hw, std=1.0 if shared else 2.0))
        mask = rand(1, g * taps, *hw)
        wt = randn(o, c, 3, 3, std=0.1)
        b = randn(o)
        kw = dict(max_displacement=d, shared_taps=shared, shared_mask=shared)
        err = 0.0
        for o_ in (noisy, off):
            ref = deform_conv2d_windowed_ref(x, o_, mask, wt, b, **kw)
            got = dcn.deform_conv2d_windowed(x, o_, mask, wt, b, **kw)
            torch.cuda.synchronize()
            err = max(err, check("kernel A", mode, 1e-4, got, ref))
        # max_displacement=None (the exact DCN) runs the kernel unclamped
        kw0 = dict(kw, max_displacement=None)
        got0 = dcn.deform_conv2d_windowed(x, noisy, mask, wt, b, **kw0)
        torch.cuda.synchronize()
        err = max(err, check("kernel A", mode + " unclamped", 1e-4, got0,
                             deform_conv2d_windowed_ref(x, noisy, mask, wt, b, **kw0)))
        xb = x.to(torch.bfloat16)
        gotb = dcn.deform_conv2d_windowed(xb, off, mask, wt, b, **kw)
        torch.cuda.synchronize()
        rel = check_bf16("kernel A", mode, gotb, ref)
        k_ms = time_ms(lambda: dcn.deform_conv2d_windowed(xb, off, mask, wt, b, **kw))
        p_ms = time_ms(lambda: deform_conv2d_windowed_ref(xb, off, mask, wt, b, **kw),
                       iters=5)
        n_px = hw[0] * hw[1]
        flops = 2 * n_px * c * 9 * o + 9 * n_px * c * 9  # contraction + samples
        record("dcn_fwd", mode, 1 if shared else 3, err, rel, k_ms, p_ms, None,
               bound([xb, off, mask, wt, b], [gotb], flops, "bfloat16"))

    # ---- B: HR state (D=32) and the concatenated lv states (D=8) -------
    for mode, (c, hw, d) in {
        "HR D=32 (1,4,720,720)": (MID // 8, WARP, 32),
        "lv D=8 (1,24,180,180)": (3 * MID // 4, q, 8),
    }.items():
        x = randn(1, c, *hw)
        noisy = randn(1, 2, *hw, std=0.75 * d)
        flow = smooth(2, hw, d)
        err = 0.0
        for f_ in (noisy, flow):
            ref = flow_warp_windowed_ref(x, f_, d)
            got = warp.flow_warp_windowed(x, f_, d)
            torch.cuda.synchronize()
            err = max(err, check("kernel B", mode, 1e-5, got, ref))
        xb = x.to(torch.bfloat16)
        gotb = warp.flow_warp_windowed(xb, flow, d)
        torch.cuda.synchronize()
        rel = check_bf16("kernel B", mode, gotb, ref)
        k_ms = time_ms(lambda: warp.flow_warp_windowed(xb, flow, d))
        p_ms = time_ms(lambda: flow_warp_windowed_ref(xb, flow, d), iters=5)
        # yardstick: grid_sample on a precomputed normalised grid (bf16, as
        # grid_sample takes the grid in x's type)
        h, w = hw
        fc = flow.clamp(-d, d)
        gx = (torch.arange(w, device=dev).view(1, 1, w) + fc[:, 0]) * (2.0 / (w - 1)) - 1
        gy = (torch.arange(h, device=dev).view(1, h, 1) + fc[:, 1]) * (2.0 / (h - 1)) - 1
        grid = torch.stack([gx, gy], dim=-1).to(torch.bfloat16)
        lib_ms = time_ms(lambda: F.grid_sample(xb, grid, mode="bilinear",
                                               padding_mode="zeros",
                                               align_corners=True))
        record("flow_warp", mode, 1, err, rel, k_ms, p_ms, lib_ms,
               bound([xb, flow], [gotb], 8 * h * w * c, "bfloat16"))

    # ---- C: r=1 (main path) and r=4 (the s2d frame) --------------------
    for r in (1, 4):
        mode = f"r={r} (1,{3 * r * r},{HR_HW[0] // r},{HR_HW[1] // r})"
        y = randn(1, 3 * r * r, HR_HW[0] // r, HR_HW[1] // r)
        lr = rand(1, 3, *LR_HW)
        ref = emit.emit_frame_ref(y, lr, r)
        got = emit.emit_frame(y, lr, r)
        torch.cuda.synchronize()
        err = check("kernel C", mode, 1e-5, got, ref)
        yb, lrb = y.to(torch.bfloat16), lr.to(torch.bfloat16)
        gotb = emit.emit_frame(yb, lrb, r)
        torch.cuda.synchronize()
        rel = check_bf16("kernel C", mode, gotb, ref)
        k_ms = time_ms(lambda: emit.emit_frame(yb, lrb, r))
        p_ms = time_ms(lambda: emit.emit_frame_ref(yb, lrb, r), iters=5)
        record("emit", mode, 1 if r == 1 else 0, err, rel, k_ms, p_ms, None,
               bound([yb, lrb], [gotb], 10 * HR_HW[0] * HR_HW[1] * 3, "bfloat16"))
    return modes


def phase_slice():
    """Phase 3. Returns the launch counts of the kernel-path run."""
    import numpy as np
    import torch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.ops.cuda import dcn, emit, warp
    from crfp_torch.params import load_npz, runtime_params_from_batch

    t = 5
    cfg = ModelConfig(mid_channels=MID, dcn_window=8, dcn_window_hr=32)
    model = CRFPRuntimeV18(cfg, warp_size=WARP, device="cuda", seed=0)
    sd, n_unmapped = runtime_params_from_batch(load_npz(str(CKPT)), model.state_dict())
    if n_unmapped != 5:
        fail(f"checkpoint adapter kept {n_unmapped} leaves at init, expected 5")
    model.load_state_dict(sd)
    model.eval()
    rng = np.random.default_rng(0)
    lrs = torch.from_numpy(rng.uniform(0, 1, (t, 1, *LR_HW, 3)).astype(np.float32)).cuda()
    fvs = torch.from_numpy(rng.uniform(0, 1, (t, 1, FV, FV, 3)).astype(np.float32)).cuda()

    def run():
        outs = []
        with torch.inference_mode():
            for i in range(t):
                x_lr, x_hr = model.encode(lrs[i], fvs[i])
                if i == 0:
                    state, out = model.step0(lrs[i], x_lr, x_hr)
                else:
                    state, out = model.step(state, lrs[i], lrs[i - 1], x_lr, x_hr)
                outs.append(out)
        torch.cuda.synchronize()
        return outs

    with plain_kernels():
        want = run()
    dcn.launches = warp.launches = emit.launches = 0
    t0 = time.perf_counter()
    got = run()
    wall = time.perf_counter() - t0
    launches = {"dcn_fwd": dcn.launches, "flow_warp": warp.launches,
                "emit": emit.launches}
    expect = {"dcn_fwd": 4 * (t - 1), "flow_warp": 2 * (t - 1), "emit": t}
    print(f"[slice] {t} frames 1080p warp {WARP} mid {MID} f32 via kernels in "
          f"{wall:.3f} s (first run, host clock); launches {launches}")
    if launches != expect:
        fail(f"launch counts {launches} != expected {expect}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != (1, *HR_HW, 3) or not bool(torch.isfinite(g).all()):
            fail(f"frame {i}: shape {tuple(g.shape)} or non-finite values")
        d = (g - w).abs()
        mse = float((d.double() ** 2).mean())
        psnr = math.inf if mse == 0 else 10 * math.log10(1.0 / mse)
        print(f"[slice] frame {i}: kernels vs plain PSNR {psnr:.2f} dB, "
              f"max|d| {float(d.max()):.3e}, frame range "
              f"[{float(g.min()):.3f}, {float(g.max()):.3f}]")
        if not (psnr >= 80.0 and float(d.max()) <= 1e-3):
            fail(f"frame {i}: kernels vs plain PSNR {psnr:.2f} dB, "
                 f"max|d| {float(d.max())}")
    return launches


def phase_bench():
    from crfp_torch.bench.runtime import run_runtime_bench
    from crfp_torch.ops.cuda import dcn, emit, warp

    dcn.launches = warp.launches = emit.launches = 0
    res = run_runtime_bench(preset="1080p", warp_size=WARP, bf16=True)
    print(f"[bench] {res}")
    print(f"[bench] launches during the bench: dcn_fwd {dcn.launches}, "
          f"flow_warp {warp.launches}, emit {emit.launches}")
    if min(dcn.launches, warp.launches, emit.launches) == 0:
        fail("the bench did not go through every kernel")
    return res


def main() -> int:
    sys.path.insert(0, str(ROOT))
    try:
        import torch

        import crfp_torch
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if Path(crfp_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"crfp_torch imported from {crfp_torch.__file__}, not from {ROOT}")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not CKPT.exists():
        fail(f"missing {CKPT}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; python {sys.version.split()[0]}")
    phase_build()
    gen = torch.Generator().manual_seed(0)
    modes = phase_kernels(gen)
    launches = phase_slice()
    phase_bench()

    kernels = []
    meta = {
        "dcn_fwd": ("crfp_torch/csrc/dcn_fwd.cu", "crfp_tpu/ops/pallas/dcn.py:59",
                    "crfp_tpu/ops/pallas/dcn.py::_dcn_kernel"),
        "flow_warp": ("crfp_torch/csrc/flow_warp.cu", "crfp_tpu/ops/pallas/warp.py:29",
                      "crfp_tpu/ops/pallas/warp.py::flow_warp_windowed_pallas "
                      "(_dcn_kernel at k=1)"),
        "emit": ("crfp_torch/csrc/emit.cu", "crfp_tpu/ops/pallas/emit.py:55",
                 "crfp_tpu/ops/pallas/emit.py::_emit_kernel"),
    }
    for name, (src, replaces, tpu) in meta.items():
        ms = [m for m in modes if m["kernel"] == name]
        on_path = [m for m in ms if m["calls_per_frame"] > 0]

        def per_frame(key):
            return sum(m[key] * m["calls_per_frame"] for m in on_path)

        lib = (per_frame("library_ms")
               if all(m["library_ms"] is not None for m in on_path) else None)
        b_ms = per_frame("bound_ms")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "tpu_counterpart": tpu, "launches": launches[name],
            "max_abs_err": max(m["max_abs_err"] for m in ms),
            "ms": per_frame("ms"), "kernel_ms": per_frame("ms"),
            "plain_ms": per_frame("plain_ms"), "bound_ms": b_ms,
            "bound_by": ("bytes" if all(m["bound_by"] == "bytes" for m in on_path)
                         else "operations"),
            "library_ms": lib,
            "per_frame_of": "main-path calls per steady-state frame, bf16 inputs",
            "modes": ms,
        })
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
