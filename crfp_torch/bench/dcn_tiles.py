"""Kernels A and E under every tile plan, and kernel D, at the main paths'
shapes.

    python -m crfp_torch.bench.dcn_tiles
    python -m crfp_torch.bench.dcn_tiles --modes   # public entry points only
    python -m crfp_torch.bench.dcn_tiles --bwd     # kernel D, every mode
    python -m crfp_torch.bench.dcn_tiles --bwd --plans   # and every plan
    python -m crfp_torch.bench.dcn_tiles --bwd --profile # device us of each launch
    python -m crfp_torch.bench.dcn_tiles --wide    # A at O = 64, every tile

For each call shape of kernel A (serving, gate and training; per-tap and
shared-tap dcn_3) and of kernel E, and each dtype given, the script times
every tile of ``crfp_torch.ops.cuda.dcn.TILE_SHAPES``, or on the
tensor-core path every tile of ``MMA_TILE_SHAPES``, and marks the plan that
``tile_plan`` takes by default. Device time: 20 calls captured in one CUDA
graph and replayed between two events (the least of 5 replays), on smooth
flow-like offsets, as ``chip_smoke.py`` times them. Every plan must give
the default plan's bits (the tile changes which block computes a pixel,
not the arithmetic); the script fails otherwise.

``--modes`` times, at the same shapes and on the same operands, every mode
of the public dispatchers (``deform_conv2d_windowed``,
``deform_conv2d_fusedprep``: bf16 and f32, clamped and unclamped) with the
default plan. It uses nothing else of the package, so it can time another
tree's kernels: ``PYTHONPATH=<tree> python <this file> --modes``.

``--bwd`` times kernel D (``dcn_backward``, the DCN stages' backward) at the
training shapes of the recipe at mid 32 and mid 16 (per-tap dcn_0/1/2 and
shared-tap dcn_3), bf16 and f32, clamped and unclamped, through the public
dispatcher and its default plan, so it also times another tree's D; a
width that tree refuses is reported as refused. ``--plans`` adds every
tile and the shared-tap patch on and off of ``bwd_plan`` for the bf16
clamped calls: d-offset and d-mask must equal the default plan's bits and
dW its value to f32 rounding (the blocks' partials change with the grid).
``--profile`` splits each bf16 clamped call into its three launches under
``torch.profiler`` (20 calls; no CUDA graph in that process, which would
cost the profiler its device events). The launches are programmatic
dependent launches, so a launch's span includes its wait for the one
before; a build with that attribute off gives disjoint spans.

``--wide`` times kernel A at O = 64 on the tensor cores (bf16, the
pyramids' and PCD's widths at the four shapes of ``chip_smoke.py``'s
``WIDE_MODES``), unclamped and at D = 8, under every tile of
``WIDE_MMA_TILE_SHAPES``, on chip_smoke.py's noisy offsets and (unclamped)
on the smooth field alone; every tile must give the default plan's bits.
``--wide --profile`` splits each call into its two launches.
Ends with one JSON line. Fails without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import torch
import torch.nn.functional as F

# (name, (n, c, h, w), o, g, D, shared, kernel): the calls on the main paths
SHAPES = [
    ("A serving per-tap", (1, 32, 180, 180), 32, 8, 8, False, "A"),
    ("A serving shared", (1, 4, 720, 720), 4, 1, 32, True, "A"),
    ("A gate per-tap", (1, 32, 180, 320), 32, 8, 8, False, "A"),
    ("A gate shared", (1, 4, 720, 1280), 4, 1, 32, True, "A"),
    ("A train per-tap", (2, 32, 48, 48), 32, 8, 8, False, "A"),
    ("A train shared", (2, 4, 192, 192), 4, 1, 32, True, "A"),
    ("E serving", (1, 32, 180, 180), 32, 8, 8, False, "E"),
    ("E gate", (1, 32, 180, 320), 32, 8, 8, False, "E"),
]


def device_ms(fn, launches: int = 20, replays: int = 5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best / launches


def _smooth(gen, n, c, hw, amp):
    lo = torch.randn(n, c, max(2, hw[0] // 32), max(2, hw[1] // 32), generator=gen)
    return F.interpolate((lo * amp).cuda(), size=hw, mode="bilinear",
                         align_corners=False).contiguous()


def _operands(gen, shape):
    """x (f32), weight, bias and A's offsets and mask or E's heads and
    flow for one entry of SHAPES, on the card."""
    name, (n, c, h, w), o, g, d, shared, kernel = shape
    taps = 1 if shared else 9
    ops = dict(x=torch.randn(n, c, h, w, generator=gen).cuda(),
               wt=(torch.randn(o, c, 3, 3, generator=gen) * 0.1).cuda(),
               b=torch.randn(o, generator=gen).cuda())
    if kernel == "A":
        ops["off"] = (_smooth(gen, n, 2, (h, w), d).repeat(1, g * taps, 1, 1)
                      + (torch.randn(n, g * taps * 2, h, w, generator=gen)
                         * (1.0 if shared else 2.0)).cuda())
        ops["mask"] = torch.rand(n, g * taps, h, w, generator=gen).cuda()
    else:
        ops["raw"] = _smooth(gen, n, g * 18, (h, w), 0.3)
        ops["rawm"] = _smooth(gen, n, g * 9, (h, w), 1.5)
        ops["flow"] = _smooth(gen, n, 2, (h, w), 3.0)
    return ops


def run_modes() -> list[dict]:
    """Device ms of every (shape, dtype, clamp) mode through the public
    dispatchers and their default plans."""
    from crfp_torch.ops.cuda.dcn import deform_conv2d_windowed
    from crfp_torch.ops.cuda.dcn_fused import deform_conv2d_fusedprep

    rows = []
    gen = torch.Generator().manual_seed(0)
    for shape in SHAPES:
        name, _, _, _, d, shared, kernel = shape
        ops = _operands(gen, shape)
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            x = ops["x"].to(dtype)
            for window in (d, None):
                if kernel == "A":
                    def call(window=window, x=x):
                        return deform_conv2d_windowed(
                            x, ops["off"], ops["mask"], ops["wt"], ops["b"],
                            max_displacement=window, shared_taps=shared, shared_mask=shared)
                else:
                    heads = (ops["raw"].to(dtype), ops["rawm"].to(dtype))

                    def call(window=window, x=x, heads=heads):
                        return deform_conv2d_fusedprep(x, *heads, ops["flow"], ops["wt"],
                                                       ops["b"], max_displacement=window)
                with torch.no_grad():
                    ms = device_ms(call)
                mode = "clamped" if window is not None else "unclamped"
                rows.append(dict(shape=name, dtype=dt, mode=mode, device_ms=ms))
                print(f"[modes] {name:18s} {dt:4s} {mode:9s} device {ms:.4f} ms")
    return rows


# (name, (n, c, h, w), o, g, D, shared): kernel D on the train step of the
# recipe (B 2, GT 192): 18 per-tap and 6 shared calls a step
BWD_SHAPES = [
    ("D mid32 per-tap", (2, 32, 48, 48), 32, 8, 8, False),
    ("D mid32 shared", (2, 4, 192, 192), 4, 1, 32, True),
    ("D mid16 per-tap", (2, 16, 48, 48), 16, 8, 8, False),
    ("D mid16 shared", (2, 2, 192, 192), 2, 1, 32, True),
]


def run_bwd(plans: bool = False) -> list[dict]:
    """Device ms of kernel D in every (shape, dtype, clamp) mode; with
    ``plans`` also every tile and patch choice of the bf16 clamped calls."""
    from crfp_torch.ops.cuda import dcn

    rows = []
    gen = torch.Generator().manual_seed(0)
    for shape in BWD_SHAPES:
        name, (n, c, h, w), o, g, d, shared = shape
        x32, off, mask, wt, g32 = _bwd_operands(gen, shape)
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            x, gout = x32.to(dtype), g32.to(dtype)
            for window in (d, None):
                mode = "clamped" if window is not None else "unclamped"
                kw = dict(max_displacement=window, shared_taps=shared, shared_mask=shared)

                def call(kw=kw, x=x, gout=gout, **extra):
                    return dcn.dcn_backward(x, off, mask, wt, gout, **kw, **extra)
                try:
                    want = call()
                except ValueError as e:  # a tree without this width
                    rows.append(dict(shape=name, dtype=dt, mode=mode, refused=str(e)))
                    print(f"[bwd] {name:16s} {dt:4s} {mode:9s} refused: {e}")
                    continue
                ms = device_ms(call)
                rows.append(dict(shape=name, dtype=dt, mode=mode, device_ms=ms))
                print(f"[bwd] {name:16s} {dt:4s} {mode:9s} device {ms:.4f} ms")
                if not (plans and dt == "bf16" and window is not None):
                    continue
                default = dcn.bwd_plan(n, c, h, w, o, g, d, shared_taps=shared,
                                       sm_count=dcn.sm_count(x.device))
                p = dcn.BWD_THREADS // g
                for tile in ((p // 32, 32), (p // 16, 16)):
                    for patch in ((True, False) if shared else (False,)):
                        plan = dcn.bwd_plan(n, c, h, w, o, g, d, shared_taps=shared,
                                            sm_count=dcn.sm_count(x.device), tile=tile,
                                            patch=patch)
                        got = call(plan=plan)
                        torch.cuda.synchronize()
                        dw_err = float((got[3] - want[3]).abs().max() / want[3].abs().max())
                        if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
                                and dw_err <= 1e-5):
                            sys.exit(f"dcn_tiles: {name} tile {tile} patch {patch}: "
                                     f"differs from the default plan (dW {dw_err})")
                        pms = device_ms(lambda plan=plan: call(plan=plan))
                        rows.append(dict(shape=name, dtype=dt, mode=mode, tile=list(tile),
                                         patch=patch, grid=plan.grid, device_ms=pms,
                                         default=plan == default))
                        print(f"[bwd plans] {name:16s} tile {tile[0]}x{tile[1]:<3d} patch "
                              f"{int(patch)} grid {plan.grid:4d}  device {pms:.4f} ms"
                              + ("  (default)" if plan == default else ""))
    return rows


def _bwd_operands(gen, shape):
    """Kernel D's operands for one entry of BWD_SHAPES, on the card: x and
    the output gradient in f32, offsets (a smooth flow-like field plus
    noise), mask and weight."""
    name, (n, c, h, w), o, g, d, shared = shape
    taps = 1 if shared else 9
    off = (_smooth(gen, n, 2, (h, w), d).repeat(1, g * taps, 1, 1)
           + (torch.randn(n, g * taps * 2, h, w, generator=gen)
              * (1.0 if shared else 2.0)).cuda())
    mask = torch.rand(n, g * taps, h, w, generator=gen).cuda()
    wt = (torch.randn(o, c, 3, 3, generator=gen) * 0.1).cuda()
    x32 = torch.randn(n, c, h, w, generator=gen).cuda()
    g32 = torch.randn(n, o, h, w, generator=gen).cuda()
    return x32, off, mask, wt, g32


def run_bwd_profile(calls: int = 20) -> list[dict]:
    """Device us per call of each of kernel D's launches, bf16 clamped."""
    from torch.profiler import ProfilerActivity, profile

    from crfp_torch.ops.cuda import dcn

    rows = []
    gen = torch.Generator().manual_seed(0)
    for shape in BWD_SHAPES:
        name, _, _, _, d, shared, *_ = shape
        x32, off, mask, wt, g32 = _bwd_operands(gen, shape)
        x, gout = x32.to(torch.bfloat16), g32.to(torch.bfloat16)
        kw = dict(max_displacement=d, shared_taps=shared, shared_mask=shared)
        for _ in range(3):
            dcn.dcn_backward(x, off, mask, wt, gout, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                dcn.dcn_backward(x, off, mask, wt, gout, **kw)
            torch.cuda.synchronize()
        spans = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            if t and "dcn_bwd_" in e.key:
                kernel = e.key.split("dcn_bwd_")[1].split("<")[0]
                spans[kernel] = spans.get(kernel, 0.0) + t / calls
        rows.append(dict(shape=name, dtype="bf16", mode="clamped", device_us=spans))
        print(f"[bwd profile] {name:16s} " + "  ".join(f"{k} {v:.1f} us"
                                                       for k, v in spans.items()))
    return rows


# (name, channels a group, (h, w)): kernel A at O = 64 on the X8 pyramid's
# levels 1-3 and PCD's finest level (chip_smoke.py's WIDE_MODES)
WIDE_SHAPES = [
    ("A O64 cpg4 (1,64,180,320)", 4, (180, 320)),
    ("A O64 cpg8 pcd (1,64,180,320)", 8, (180, 320)),
    ("A O64 cpg16 (1,64,360,640)", 16, (360, 640)),
    ("A O64 cpg64 (1,64,720,1280)", 64, (720, 1280)),
]


def _wide_operands(gen, cpg, hw):
    """x (bf16), weight, bias, mask and two offset fields of kernel A at O
    = 64: ``noisy``, chip_smoke.py's (a smooth flow-like field of std D = 8
    plus white noise of std 2 for every group and tap), and ``smooth``, the
    field alone (every tap of a pixel displaced alike)."""
    c = o = 64
    g, d = c // cpg, 8
    field = _smooth(gen, 1, 2, hw, d).repeat(1, g * 9, 1, 1)
    return dict(
        x=torch.randn(1, c, *hw, generator=gen).cuda().to(torch.bfloat16),
        noisy=field + (torch.randn(1, g * 18, *hw, generator=gen) * 2.0).cuda(),
        smooth=field.contiguous(),
        mask=torch.rand(1, g * 9, *hw, generator=gen).cuda(),
        wt=(torch.randn(o, c, 3, 3, generator=gen) * 0.05).cuda(),
        b=torch.randn(o, generator=gen).cuda())


def run_wide() -> list[dict]:
    """Device ms of kernel A at O = 64 in bf16 under every tile of the
    tensor-core plan, unclamped and at D = 8, on noisy and smooth offsets."""
    from crfp_torch.ops.cuda import dcn

    rows = []
    gen = torch.Generator().manual_seed(0)
    for name, cpg, (h, w) in WIDE_SHAPES:
        c = o = 64
        g, d = c // cpg, 8
        ops = _wide_operands(gen, cpg, (h, w))
        x, mask, wt, b = ops["x"], ops["mask"], ops["wt"], ops["b"]
        for window, kind in ((None, "noisy"), (d, "noisy"), (None, "smooth")):
            off = ops[kind]
            mode = ("clamped" if window is not None else "unclamped") + f" {kind}"
            default = dcn.tile_plan(1, c, h, w, o, g, window, bf16=True,
                                    sm_count=dcn.sm_count(x.device))
            want = dcn.dcn_forward(x, off, mask, wt, b, max_displacement=window)
            for tile in dcn.WIDE_MMA_TILE_SHAPES:
                plan = dcn.tile_plan(1, c, h, w, o, g, window, bf16=True, tile=tile)

                def call(plan=plan, window=window):
                    return dcn.dcn_forward(x, off, mask, wt, b, max_displacement=window,
                                           plan=plan)
                got = call()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    sys.exit(f"dcn_tiles: {name} {mode} tile {tile}: "
                             "differs from the default plan's bits")
                ms = device_ms(call)
                row = dict(shape=name, dtype="bf16", mode=mode, tile=list(tile),
                           tiles=plan.tiles_y * plan.tiles_x, device_ms=ms,
                           default=plan == default)
                rows.append(row)
                print(f"[wide] {name:30s} {mode:16s} tile {tile[0]}x{tile[1]:<3d} "
                      f"{row['tiles']:6d} tiles  device {ms:.4f} ms"
                      + ("  (default)" if row["default"] else ""))
    return rows


def run_wide_profile(calls: int = 20) -> list[dict]:
    """Device us per call of kernel A's two launches at O = 64 (the
    pre-pass and the tiled kernel), bf16 unclamped on noisy offsets."""
    from torch.profiler import ProfilerActivity, profile

    from crfp_torch.ops.cuda import dcn

    rows = []
    gen = torch.Generator().manual_seed(0)
    for name, cpg, hw in WIDE_SHAPES:
        ops = _wide_operands(gen, cpg, hw)
        args = (ops["x"], ops["noisy"], ops["mask"], ops["wt"], ops["b"])
        for _ in range(3):
            dcn.dcn_forward(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                dcn.dcn_forward(*args)
            torch.cuda.synchronize()
        spans = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            if t and "dcn_fwd_kernel" in e.key:
                kernel = "pack_x" if "pack_x" in e.key else "tiled"
                spans[kernel] = spans.get(kernel, 0.0) + t / calls
        rows.append(dict(shape=name, dtype="bf16", mode="unclamped noisy", device_us=spans))
        print(f"[wide profile] {name:30s} " + "  ".join(f"{k} {v:.1f} us"
                                                      for k, v in spans.items()))
    return rows


def run(dtypes=("bf16",)) -> list[dict]:
    from crfp_torch.ops.cuda import dcn, dcn_fused

    rows = []
    gen = torch.Generator().manual_seed(0)
    for shape in SHAPES:
        name, (n, c, h, w), o, g, d, shared, kernel = shape
        ops = _operands(gen, shape)
        x32, wt, b = ops["x"], ops["wt"], ops["b"]
        for dt in dtypes:
            dtype = torch.bfloat16 if dt == "bf16" else torch.float32
            x = x32.to(dtype)
            default = dcn.tile_plan(n, c, h, w, o, g, d, bf16=dt == "bf16",
                                    shared_mask=shared, sm_count=dcn.sm_count(x.device))
            mma = default.mma
            for tile in dcn.MMA_TILE_SHAPES if mma else dcn.TILE_SHAPES:
                plan = dcn.tile_plan(n, c, h, w, o, g, d, bf16=dt == "bf16",
                                     shared_mask=shared, tile=tile)
                if kernel == "A":
                    def call(plan=plan):
                        return dcn.dcn_forward(x, ops["off"], ops["mask"], wt, b,
                                               max_displacement=d, shared_taps=shared,
                                               shared_mask=shared, plan=plan)
                else:
                    heads = (ops["raw"].to(dtype), ops["rawm"].to(dtype))

                    def call(plan=plan, heads=heads):
                        return dcn_fused.deform_conv2d_fusedprep(
                            x, *heads, ops["flow"], wt, b, max_displacement=d, plan=plan)
                got = call()
                want = call(default)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    sys.exit(f"dcn_tiles: {name} {dt} tile {tile}: "
                             "differs from the default plan's bits")
                ms = device_ms(call)
                row = dict(shape=name, dtype=dt, tile=list(tile), smem_bytes=plan.smem_bytes,
                           tiles=n * plan.tiles_y * plan.tiles_x, device_ms=ms,
                           default=plan == default)
                rows.append(row)
                print(f"[tiles] {name:18s} {dt:4s} tile {tile[0]}x{tile[1]:<3d} "
                      f"{plan.smem_bytes:7d} B {row['tiles']:5d} tiles  device {ms:.4f} ms"
                      + ("  (default)" if row["default"] else ""))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtypes", nargs="+", default=["bf16"], choices=["bf16", "f32"])
    ap.add_argument("--modes", action="store_true",
                    help="time every mode of the public dispatchers with the default plan")
    ap.add_argument("--bwd", action="store_true",
                    help="time kernel D in every mode at the training shapes")
    ap.add_argument("--plans", action="store_true",
                    help="with --bwd: also every tile and patch choice of bwd_plan")
    ap.add_argument("--profile", action="store_true",
                    help="with --bwd or --wide: device time of each launch under "
                         "torch.profiler")
    ap.add_argument("--wide", action="store_true",
                    help="time kernel A at O = 64 (bf16) under every tile of its plan")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("dcn_tiles: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}")
    if args.modes:
        print(json.dumps({"dcn_modes": run_modes()}))
        return 0
    if args.wide and args.profile:
        print(json.dumps({"dcn_wide_profile": run_wide_profile()}))
        return 0
    if args.wide:
        print(json.dumps({"dcn_wide_tiles": run_wide()}))
        return 0
    if args.bwd and args.profile:
        print(json.dumps({"dcn_bwd_profile": run_bwd_profile()}))
        return 0
    if args.bwd:
        print(json.dumps({"dcn_bwd_modes": run_bwd(args.plans)}))
        return 0
    rows = run(tuple(args.dtypes))
    print(json.dumps({"dcn_tiles": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
