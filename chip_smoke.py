"""Smoke run of the PyTorch/CUDA port (crfp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only    # phases 1, 2 and 5 alone
    python3 chip_smoke.py --parallel-only   # phases 1 and 10 alone
    python3 chip_smoke.py --tools-only      # phases 1 and 11 alone

Two times are read for every kernel mode, its plain version and, where
there is one, the PyTorch call that computes the same function. The
**call time** (``call_ms``; also ``ms``, ``plain_ms``, ``library_ms``) is an
eager Python loop of calls between two CUDA events: it is the larger of
what the host needs to make a call and what the card needs to run it, so
for a kernel of a few microseconds it is a reading of the dispatcher and
the launch path. The **device time** (``device_ms``) is the same calls
captured in one CUDA graph and replayed between two events: no host in
it, so it is what the card needs, and it also proves that the call can
be captured. A kernel whose ``call_ms`` is far above its ``device_ms`` is
host-bound in an eager loop; one whose two times agree is device-bound.
Each mode also prints a digest of its (deterministic) results: two trees
that print the same digests computed the same bits.

Phases, in order; any failure exits non-zero without the final line:
1. print the card (nvidia-smi name, power limit) and build the kernels of
   crfp_torch/csrc with nvcc (sm_90a), all sources in parallel;
2. hold each kernel against its plain PyTorch version on the card at the
   main-path shapes (1080p, warp 720^2, mid 32): f32 with TF32 off, A to
   1e-4 abs, B and C to 1e-5 abs; bf16 inputs against the f32 plain
   version to 2e-2 of max|ref|; time kernel, plain version and, where one
   PyTorch call computes the same function, that call (device and call
   time each; for B also a device copy of as many bytes as its bound
   counts, and a replay of B from a CUDA graph must equal the eager
   call). Kernel E
   (dcn_fused) at the serving shape (1,32,180,180) and the gate shape
   (1,32,180,320): f32 to 1e-4 of max|ref| on white-noise and smooth heads,
   bf16 x and heads to 2e-2 of max|ref| against the f32 plain version on
   the same (rounded) values, and f32 against the PyTorch prologue followed
   by kernel A on the same operands to 1e-5 on a smooth field; timed beside
   its plain version and beside prologue + A; in bf16 E must equal
   prologue + A bit for bit. Kernels A and B are held
   the same way at the gate's 16:9 shapes too (A per-tap (1,32,180,320)
   and shared (1,4,720,1280), each clamped and unclamped; B (1,4,720,1280),
   (1,32,180,320) and (1,24,180,320), and unclamped the variants'
   lv3_state (1,32,180,320), basic_fvsr's stack (1,128,180,320), the gen-1
   pyramids' level states (1,64,360,640) and (1,64,720,1280) and a frame of
   the flow-warp evaluation (1,3,720,1280)), A at
   the training shapes
   ((2,32,48,48) per-tap, 36 calls per amp step; (2,4,192,192) shared, 12),
   and A and E at the mid-16 widths (A per-tap (1,16,180,180) at O = 16 and
   shared (1,2,720,720) at O = 2; E (1,16,180,180) at O = 16), and A at O = 64
   (the pyramids' and PCD's widths: 4 channels a group at (1,64,180,320), 8
   at (1,64,180,320), 16 at (1,64,360,640), 64 at (1,64,720,1280)), each
   clamped at D = 8 and unclamped, f32 and bf16, timed unclamped in bf16
   with the f32 device time beside it, its bound the larger of the bytes and
   the contraction at the bf16 tensor-core peak (``f32_ops_ms``: at the f32
   CUDA-core peak).
   A and E must give the same bits in two runs and replayed from a CUDA
   graph, and A under shared taps the bits of its per-tap loop on the
   repeated offset; their records carry the tile plan and
   ``bound_fraction`` (bound over device time). Kernel C at r=1 and r=4
   (1080p), at the pyramids' frames (1,3,720,1280) and (1,3,360,640) from LR
   90x160, at a width that is not a multiple of 8 ((1,3,270,486) from
   34x61) and on y read through a view offset by one element: the 1080p
   r=1 frame must take the row route (emit_plan) in bf16 and f32, the
   offset view the pixel route with the row route's bits; two runs and a
   CUDA-graph replay bit-equal; its records carry the route and
   ``bound_fraction``;
3. drive the slice through its entry points (encode, step0, step) over 5
   frames at 1080p / warp 720^2 / mid 32 with checkpoints/v18_mid32_struct.npz,
   once through the kernels and once through the plain versions, both in
   f32; every frame must agree to >= 80 dB PSNR and max|d| <= 1e-3, and
   the launch counters must show A 4, B 2, C 1 per steady-state frame;
   3b. the same at mid 16 with checkpoints/v18_mid16_procedural.npz (A at
   O = 16 and O = 2), then 4 frames of a 720p gate clip of that checkpoint
   through StreamingRunner, EXACT and DEPLOY with dcn_fused (E at O = 16),
   both in f32, kernels against plain versions as above, launch counts
   asserted;
   3c. the trunk variants beside v18 (``ModelConfig.variant``, ``hr_dcn``,
   ``y_only``) through StreamingRunner at mid 32, windows 8/32, on that
   720p clip: checkpoints/basic_fvsr_mid32_struct.npz and
   no_dcn_mid32_struct.npz (strict loads, hr_dcn=False) over 4 frames, and
   seeded random weights with random offset/mask heads for v13 and v15
   (hr_dcn on and off), v18_cra and v18 with y_only over 3, each in f32
   through the kernels and through the plain versions (>= 80 dB, max|d|
   <= 1e-3 per frame), launches per steady frame asserted (basic_fvsr A 4,
   B 1; no_dcn A 0, B 1, both warps unclamped; v13/v15 A 4, B 1; v18_cra
   and y_only A 4, B 3); basic_fvsr in bf16 with dcn_fused (E 3, A 1, B 1)
   against bf16 without it (>= 60 dB); the train step of basic_fvsr (3 f32
   steps) and no_dcn (2) from their checkpoints at the recipe, through the
   kernels against the plain versions as in phase 6 with launch counts
   asserted, then 5 amp steps each that must stay finite; last, ms per
   steady bf16 frame of every variant and of v18 at that shape (CUDA
   events, every configuration in order and in reverse);
   3d. the models beside the trunk, each in f32 through the kernels and
   through the plain versions (>= 80 dB, max|d| <= 1e-3 per frame), launches
   asserted: CRFPRuntimeSimple v13 and v15 (seeded, random heads) and
   CRFPRuntimeV18(nofv=True) (checkpoints/v18_mid32_struct.npz through
   runtime_params_from_batch) over 4 frames at 1080p / warp 720^2 / mid 32,
   windows 8/32 (A 4, B 1 or, nofv, 2, C 1 a steady frame); the v18 trunk
   with flow_net="spynet" (seeded) through StreamingRunner on the 720p clip
   (A 4, B 3), 2 f32 train steps at the recipe against plain versions and 3
   amp steps that must stay finite; flow_warp_propagation_eval with SPyNet
   and FNet on 6 frames of the 720p clip (B 1, F 5 a call; PSNR within 1e-3
   dB and SSIM within 1e-5 of the plain versions'); CRFPPyramidX8 and
   CRFPPyramidX4, plain and CRA, at mid 64, dg 16, on 3 frames of the 720p
   clip, dcn_window None (and X8 plain at 8) (X8 A 4, B 4, C 1 a steady
   frame, X4 A 4, B 3, C 1, the cold frame C 1); a DCN at O = 64 that
   autograd records must raise (kernel D does not take it); PCDAlign at nf
   64, 8 groups on (1,64,180,320) (A 4); then ms per steady bf16 frame of
   the runtime models beside seeded v18 at 1080p and of the four pyramids
   (CUDA events, in order and reversed);
4. time the bf16 slice with crfp_torch.bench.runtime.run_runtime_bench,
   in turns with ModelConfig.dcn_fused off, on, on, off (off: A 4, B 2, C 1
   per steady frame; on: E 3, A 1, B 2, C 1), launch counts asserted;
5. hold the training kernels against their plain versions at the training
   shapes of the recipe of record (B 2, T 7, GT 192, mid 32; TF32 off):
   kernel D (dcn_bwd, flow_warp_bwd) gradients f32 to 1e-4 of max|ref|,
   bf16 inputs against the f32 plain version to 2e-2 of max|ref|, at mid 32
   and at the mid-16 widths (O 16 and 2), d-offset, d-mask and dW
   bit-equal over two runs and a CUDA-graph replay; kernel F
   (ssim) map to 1e-5 abs and mean to 1e-6 at (14,192,192,3),
   (14,192,192,1), (1,1080,1920,3), the gate's (1,720,1280,3) and the
   ragged (1,5,7,1), (2,33,65,1), (1,11,11,3), NCHW-contiguous and as NCHW
   views of NHWC memory and in the train step's layouts (its output an NHWC
   view of NCHW memory, its ground truth NHWC), all bit-equal, two runs and
   a CUDA-graph replay bit-equal, its records carrying its plan and
   ``bound_fraction``; at the two training shapes also the kernel and the
   whole masked SSIM on the step's layouts, read in place as the metric
   reads them; time kernel, plain version and,
   where one PyTorch call computes the same function, that call (device
   and call time each). The warp's d-flow is reduced without atomics: two
   runs and a CUDA-graph replay on the same inputs must be bit-equal, also
   unclamped at basic_fvsr's stack of four states (2,128,48,48);
6. train the batch CRFP from checkpoints/v18_mid32_struct.npz (strict
   load, windows 8/32, remat): 3 f32 steps through the kernels against 3
   through the plain versions from the same state and batches (losses to
   1e-4 relative, every parameter to 2*lr*steps), with the launch counts
   of every kernel asserted; then 10 amp steps on one batch from the
   checkpoint, which must stay finite, and 10 from the seeded init, which
   must also descend;
7. time the amp train step (crfp_torch.bench.train.run_train_bench), the
   training main path, with the launch counts of every kernel asserted;
8. run the deployment quality gate (crfp_torch.bench.deploy_gate.run_gate)
   at full width: checkpoints/v18_mid32_procedural.npz, mid 32, LR 90x160 ->
   720x1280, fovea 96, sigmas 10/50/100, 20 frames each, EXACT (f32,
   unclamped) against DEPLOY (bf16, windows 8/32, dcn_fused). Every zone
   must hold |dPSNR| <= 0.05 dB and every sigma an exact-vs-deploy
   agreement >= 50 dB (the JAX package documents >= 51.5 dB for its own
   deployment configuration, docs/DEPLOY.md); the launch counts of the run
   and of each path alone (EXACT: A 4, B 3 per steady frame, E 0; DEPLOY:
   E 3, A 1, B 3; DEPLOY without dcn_fused: A 4, B 3; F 1 per evaluated
   frame and evaluator; C 0) are asserted, and DEPLOY with and without
   dcn_fused must agree to >= 60 dB over one sigma. Then 4 frames of that
   clip go through EXACT, DEPLOY with dcn_fused and DEPLOY without it,
   each in f32, once through the kernels and once through the plain
   versions (>= 80 dB and max|d| <= 1e-3 per frame, as in phase 3), and
   through bf16 DEPLOY with dcn_fused (>= 60 dB per frame); the zone
   evaluation of the kernels' frames with kernel F must equal the one with
   F's plain version to 1e-4 dB and 1e-5 SSIM;
9. drive the reference's own entry point, ``python -m crfp_torch.main``
   (``crfp_torch.main.main(argv)``), on a REDS-shaped tree written from a
   seed under a temporary directory (GT 720x1280, LR 90x160 in
   ``REDS_sharp_BI_x8``, smooth content moving a whole number of HR pixels
   a frame; one held-out clip of 15 frames symlinked under the four train
   and four val held-out names; two training clips of 26 frames, 24
   windows): train with train.sh's flags (v18, mid 32, scale 8, batch 8,
   FV 128, GT 256, N_frames 15, rates 2e-4 / 2.5e-5, 9 loader threads, the
   frame cache, f32, the exact unclamped DCN, ``--num_gpu 4`` as train.sh
   has it: a world of 1 on this one card, which the log must say) with
   only ``--num_epochs 1 --save_every 3 --viz_every 3`` changed: 3 steps, the
   dashboard dump and the validation at 720p, launches of A, B, D and F
   asserted, every loss finite, the checkpoint, metrics.jsonl and the viz
   PNGs on disk; ``CheckpointManager.restore`` must give back the model,
   both Adam groups and the step bit for bit; the loader alone (ms a
   batch) and the train step at the full recipe (ms, peak memory); two f32
   steps from one loader batch through the kernels against two through
   the plain versions (losses to 1e-4 relative, parameters to
   2*lr*steps, launches asserted); eval.sh (over the model directory;
   PSNR within 1e-3 dB and SSIM within 1e-5 of the same evaluation through
   the plain versions, launches asserted) and test.sh; ms a 720p eval
   frame; the held-out clip on disk through ``crfp_torch.tools.test_video``
   (kernels against plain versions, >= 80 dB a frame, launches asserted).
   Phase 5 also holds kernel D unclamped at train.sh's shapes;
10. the parallel paths (crfp_torch.parallel) on the one card, each rank a
   spawned process (the kernels built once, in phase 1, before any starts;
   every rank joined with a timeout and its exit code checked): a one-rank
   NCCL group through ``initialize_distributed`` (an all-reduce of a CUDA
   tensor, a barrier, destroyed); then two ranks sharing cuda:0 over gloo
   (NCCL refuses two ranks on one device): 2 f32 data-parallel steps of
   the batch CRFP from checkpoints/v18_mid32_struct.npz (strict, windows
   8/32, remat) at the recipe's shapes (global B 2, T 7, GT 192) against
   the one-process step on the same batches (losses to 1e-4 relative,
   parameters to 2*lr*steps, the ranks' parameters bit-equal by digest,
   launches of A, B, D and F per rank asserted), and
   ``SpatialStreamingRunner`` over 3 frames of phase 3b's 720p clip (LR
   90x160, v18 mid 32 from that checkpoint, f32) with windows 8/32 and
   unclamped against ``StreamingRunner`` (>= 80 dB and max|d| <= 1e-3 a
   frame; A 4 and B 3 launches a steady frame per rank); ms a step and a
   frame of the two ranks beside one process (the halo and collective
   overhead on one card, not scaling); last, one step of ``python -m
   crfp_torch.main --cpu false`` with train.sh's flags (``--num_gpu 4``;
   batch 24, the tree's 24 windows, no validation) on phase 9's tree,
   whose log must say world 1;
11. the tools and benches (crfp_torch.bench, crfp_torch.tools): the
   capability ablation (``bench.capability.run_capability``) at its
   defaults on checkpoints/{no_dcn,basic_fvsr,v18}_mid32_struct.npz (hr 768,
   20 frames x sigmas 10/50/100, mid 32, bf16, v18 at windows 8/32 under the
   plain clamp; A 8, B 5 a steady frame over the three rows, F 4 a frame),
   its table printed with the card's name and power limit and its deltas
   beside the JAX package's TPU reading (a report); sigma 10's first 6
   frames of each trained row through the kernels and through the plain
   versions, in f32 (>= 80 dB and max|d| <= 1e-3 a frame) and in bf16
   (>= 55 dB and max|d| <= 0.05 a frame, per-frame zone PSNR within
   0.05 dB); the
   window-quality harnesses at their defaults (ground-truth flow: every
   pair inside the window, 2v <= D, agrees to >= 80 dB; the trained
   checkpoint's learned flow: the table), launches asserted; the trained
   v18 checkpoint written under the reference's names as a ``.pt``
   (``crfp_torch.params.to_reference``) read back through
   ``load_params`` equal to the ``.npz`` and streamed at the serving shape
   bit-equal to it; ``tools.test_runtime`` per stage and fused at 1080p /
   warp 720^2 / bf16 / windows 8/32 and ``tools.bench``'s three protocols
   uncut, launches asserted, ``stage_seconds`` printed; the trace table of
   10 serving frames in a child process (no CUDA graph before it there),
   which must show kernels A, B and C; ``flow_to_color`` on a flow computed
   on the card and ``combine_gifs`` on GIFs of emitted frames (the mp4
   tools need OpenCV, which the card's machine may lack: the CPU tests
   hold them);
12. print one {"kernels": [...]} line (``launches_parallel``: rank 0's
   launches over phase 10's checked runs; ``launches_tools``: the launches
   over phase 11, its child process excluded) and, last, the
   {"ok": true, ...} line.

Imports nothing of JAX or of crfp_tpu.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "checkpoints" / "v18_mid32_struct.npz"
GATE_CKPT = ROOT / "checkpoints" / "v18_mid32_procedural.npz"
# the mid-16 checkpoint: dcn_0/1/2 at O = 16 (2 channels per group), dcn_3 at O = 2
MID16_CKPT = ROOT / "checkpoints" / "v18_mid16_procedural.npz"
MID16_FRAMES = 4
GATE_LR_HW, GATE_FRAMES, GATE_SIGMAS = (90, 160), 20, (10.0, 50.0, 100.0)
# exact-vs-deploy agreement of the gate, dB; frames of the gate streamed through
# the plain versions, and the bf16 limit of kernels against plain there, dB
GATE_AGREE_DB, GATE_PLAIN_FRAMES, GATE_PLAIN_BF16_DB = 50.0, 4, 60.0

# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; bf16 tensor
# cores 989 TFLOP/s; f32 outside the tensor cores 67 TFLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

LR_HW, HR_HW, WARP, FV, MID = (135, 240), (1080, 1920), (720, 720), 96, 32
# train.sh's batch and GT crop (phases 5 and 9)
MAIN_B, MAIN_GT = 8, 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Call time: ms per call of an eager loop of ``iters`` calls between two
    CUDA events. It reads the larger of the host's time to make a call and
    the device's time to run it; for a kernel of a few microseconds that is
    the host."""
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


def device_time_ms(fn, launches: int = 20, replays: int = 5, stream=None) -> float:
    """Device time: ms per call of ``launches`` calls of ``fn`` captured in
    one CUDA graph and replayed between two events (the least of
    ``replays``). A replay runs everything ``fn`` puts on the card
    (kernels, memsets, copies) back to back with no host in between, so it
    reads what the card needs for a call, the gaps between dependent
    launches included. ``fn`` must have run before (warm) and be
    capturable: current stream, no synchronisation, PyTorch's allocator.
    ``stream``: the stream to capture on (autograd runs a backward on the
    stream its forward ran on, so such a ``fn`` is captured there)."""
    import torch

    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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
    del graph
    return best / launches


def measure(fn, iters: int = 20, capturable: bool = True) -> tuple[float, float | None]:
    """(call ms, device ms) of ``fn``: :func:`time_ms`, then
    :func:`device_time_ms`, one method for kernels, plain versions and
    library calls alike. ``capturable=False`` (a plain version that copies
    from the host) leaves the device time out."""
    return (time_ms(fn, iters=iters),
            device_time_ms(fn, launches=iters) if capturable else None)


def captured(fn):
    """The result of ``fn()`` replayed from a CUDA graph: ``fn`` is warmed
    up and captured on a side stream, its output zeroed, the graph replayed.
    Fails the capture if ``fn`` synchronises or allocates outside PyTorch's
    allocator."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return out


def digest(*tensors) -> str:
    """Short SHA-256 of the tensors' bytes: equal digests of two builds on
    the same seeded inputs mean bit-equal results."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:12]


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
    """Route the models', the metric's and the zone evaluator's kernel call sites to the plain
    versions (they call the dispatchers by these module-level names); on
    the plain versions autograd of plain PyTorch applies."""
    import crfp_torch.eval.flow_warp_eval as fw
    import crfp_torch.eval.zones as zn
    import crfp_torch.models.crfp as cr
    import crfp_torch.models.pyramid as py
    import crfp_torch.models.runtime as rt
    import crfp_torch.nn.align as al
    import crfp_torch.ops.metrics as mt
    from crfp_torch.ops.cuda.emit import emit_frame_ref
    from crfp_torch.ops.cuda.ssim import ssim_map_ref
    from crfp_torch.ops.dcn_windowed import (
        deform_conv2d_fusedprep_ref,
        deform_conv2d_windowed_ref,
    )
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    sites = [(al, "deform_conv2d_windowed", deform_conv2d_windowed_ref),
             (al, "deform_conv2d_fusedprep", deform_conv2d_fusedprep_ref),
             (rt, "flow_warp_windowed", flow_warp_windowed_ref),
             (rt, "emit_frame", emit_frame_ref),
             (cr, "flow_warp_windowed", flow_warp_windowed_ref),
             (py, "deform_conv2d_windowed", deform_conv2d_windowed_ref),
             (py, "flow_warp_windowed", flow_warp_windowed_ref),
             (py, "emit_frame", emit_frame_ref),
             (fw, "flow_warp_windowed", flow_warp_windowed_ref),
             (mt, "ssim_map", ssim_map_ref),
             (zn, "ssim_map", ssim_map_ref)]
    saved = [getattr(m, name) for m, name, _ in sites]
    for m, name, plain in sites:
        setattr(m, name, plain)
    try:
        yield
    finally:
        for (m, name, _), fn in zip(sites, saved):
            setattr(m, name, fn)


def phase_build():
    from crfp_torch.ops.cuda import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s "
          f"({_build.find_nvcc()})")
    for name in sorted(libs):
        # the file name carries a hash of the source, its headers and the
        # flags: equal names across two trees mean the same device code
        print(f"[build] {name}: {libs[name].name}")
        log = _build.BUILD_DIR / f"{name}.log"
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def _record(modes, kernel, mode, calls, err, bf16_rel, k_ms, p_ms, lib_ms, bnd,
            **extra):
    """Print one (kernel, call shape) line and append its record; ``calls``
    is the number of such calls per unit of the kernel's own main path (a
    serving frame, a train step, a DEPLOY frame of the gate). ``k_ms``,
    ``p_ms`` and ``lib_ms`` (None where no PyTorch call computes the same
    function) are (call ms, device ms) pairs of :func:`measure`."""
    b_ms, b_by, t_bytes, t_ops = bnd
    (k_call, k_dev), (p_call, p_dev) = k_ms, p_ms
    lib_call, lib_dev = lib_ms if lib_ms is not None else (None, None)

    def pair(call, dev):
        if call is None:
            return "-"
        return f"device {'-' if dev is None else f'{dev:.4f}'} call {call:.4f} ms"

    print(f"[kernel] {kernel:13s} {mode:34s} f32 max|d| {err:.3e}  bf16 "
          f"max|d|/max|ref| {'-' if bf16_rel is None else f'{bf16_rel:.3e}'}  "
          f"kernel {pair(k_call, k_dev)}  plain {pair(p_call, p_dev)}  library "
          f"{pair(lib_call, lib_dev)}  bound "
          f"{b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f}, ops {t_ops:.4f})"
          + "".join(f"  {k} {v:.4g}" if isinstance(v, float) else f"  {k} {v}"
                    for k, v in extra.items()))
    modes.append(dict(kernel=kernel, mode=mode, calls=calls, max_abs_err=err,
                      bf16_rel_err=bf16_rel, ms=k_call, call_ms=k_call, device_ms=k_dev,
                      plain_ms=p_call, plain_device_ms=p_dev, library_ms=lib_call,
                      library_call_ms=lib_call, library_device_ms=lib_dev,
                      bound_ms=b_ms, bound_by=b_by, **extra))


def _smooth(gen, c, hw, amp, n=1):
    """A flow-like field (n, c, *hw) on the card: std ``amp``, varying over
    ~32 pixels."""
    import torch
    import torch.nn.functional as F

    lo = torch.randn(n, c, max(2, hw[0] // 32), max(2, hw[1] // 32), generator=gen)
    return F.interpolate((lo * amp).cuda(), size=hw, mode="bilinear",
                         align_corners=False).contiguous()


def phase_kernels(gen):
    """Phase 2. Returns the per-kernel records (without launches)."""
    import torch
    import torch.nn.functional as F

    from crfp_torch.ops.cuda import dcn, dcn_fused, emit, warp
    from crfp_torch.ops.dcn_windowed import (
        deform_conv2d_fusedprep_ref,
        deform_conv2d_windowed_ref,
        fusedprep_offsets_and_mask,
    )
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    dev = "cuda"

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    q = (WARP[0] // 4, WARP[1] // 4)
    # the gate's 16:9 planes: the 1/4-res stages and the HR level
    gq = (GATE_LR_HW[0] * 2, GATE_LR_HW[1] * 2)
    ghr = (GATE_LR_HW[0] * 8, GATE_LR_HW[1] * 8)
    modes = []  # one record per (kernel, main-path call shape)
    record = functools.partial(_record, modes)

    def smooth(c, hw, amp):
        return _smooth(gen, c, hw, amp)

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

    # ---- A: per-tap (dcn_0/1/2) and shared-tap (dcn_3), at the serving
    # shapes, at the gate's (each also unclamped, as the gate's EXACT side
    # runs it) and at the training shapes (calls per amp train step: 2 x 3
    # x (T-1) per-tap and 2 x (T-1) shared, forward and remat) -------------
    from crfp_torch.bench.train import RECIPE

    tb, tn_rec, tlv = RECIPE["b"], RECIPE["t"] - 1, (RECIPE["gt"] // 4, RECIPE["gt"] // 4)
    tgt = (RECIPE["gt"], RECIPE["gt"])
    for mode, (n, c, o, g, hw, d, shared, calls, per_step) in {
        "per-tap G=8 D=8 (1,32,180,180)": (1, MID, MID, 8, q, 8, False, 3, 0),
        "shared G=1 D=32 (1,4,720,720)": (1, MID // 8, MID // 8, 1, WARP, 32, True, 1, 0),
        f"per-tap G=8 D=8 (1,32,{gq[0]},{gq[1]}) gate": (1, MID, MID, 8, gq, 8, False, 0, 0),
        f"shared G=1 D=32 (1,4,{ghr[0]},{ghr[1]}) gate": (1, MID // 8, MID // 8, 1, ghr, 32,
                                                        True, 0, 0),
        f"per-tap G=8 D=8 ({tb},32,{tlv[0]},{tlv[1]}) train": (tb, MID, MID, 8, tlv, 8, False,
                                                             0, 6 * tn_rec),
        f"shared G=1 D=32 ({tb},4,{tgt[0]},{tgt[1]}) train": (tb, MID // 8, MID // 8, 1, tgt, 32,
                                                            True, 0, 2 * tn_rec),
        # the mid-16 widths (checkpoints/v18_mid16_procedural.npz), serving shapes
        "per-tap G=8 D=8 (1,16,180,180) mid16": (1, 16, 16, 8, q, 8, False, 0, 0),
        "shared G=1 D=32 (1,2,720,720) mid16": (1, 2, 2, 1, WARP, 32, True, 0, 0),
    }.items():
        taps = 1 if shared else 9
        x = randn(n, c, *hw)
        noisy = randn(n, g * taps * 2, *hw, std=0.75 * d)
        off = (_smooth(gen, 2, hw, d, n=n).repeat(1, g * taps, 1, 1)
               + randn(n, g * taps * 2, *hw, std=1.0 if shared else 2.0))
        mask = rand(n, g * taps, *hw)
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
        # sums in a fixed order: a second run and a replay from a CUDA graph
        # give the same bits
        again = dcn.deform_conv2d_windowed(xb, off, mask, wt, b, **kw)
        if not torch.equal(again, gotb):
            fail(f"kernel A {mode}: two runs on the same inputs differ")
        if not torch.equal(captured(lambda: dcn.deform_conv2d_windowed(xb, off, mask, wt, b,
                                                                        **kw)), gotb):
            fail(f"kernel A {mode}: replayed from a CUDA graph it differs from the eager call")
        # shared taps read one 4x4 patch for all 9 taps: the per-tap loop on
        # the offset repeated for every tap gives the same bits
        if shared and not torch.equal(gotb, dcn.deform_conv2d_windowed(
                xb, off.repeat(1, 9, 1, 1).contiguous(), mask, wt, b,
                **dict(kw, shared_taps=False))):
            fail(f"kernel A {mode}: the shared-tap patch differs from the per-tap loop")
        k_ms = measure(lambda: dcn.deform_conv2d_windowed(xb, off, mask, wt, b, **kw))
        p_ms = measure(lambda: deform_conv2d_windowed_ref(xb, off, mask, wt, b, **kw),
                       iters=5)
        n_px = n * hw[0] * hw[1]
        flops = 2 * n_px * c * 9 * o + 9 * n_px * c * 9  # contraction + samples
        bnd = bound([xb, off, mask, wt, b], [gotb], flops, "bfloat16")
        plan = dcn.tile_plan(n, c, *hw, o, g, d, bf16=True, shared_mask=shared)
        record("dcn_fwd", mode, calls, err, rel, k_ms, p_ms, None, bnd,
               calls_per_step=per_step, bound_fraction=bnd[0] / k_ms[1],
               tile=f"{plan.tile_h}x{plan.tile_w} pad {plan.pad}{' mma' if plan.mma else ''}",
               digest=digest(got, got0, gotb))

    # ---- A at O = 64 (the pyramids' and PCD's per-tap DCNs at mid / nf 64),
    # 4, 8, 16 and 64 channels a group, each clamped at D = 8 and unclamped
    # (the pyramids' default, dcn_window=None). Operands from a generator of
    # their own, so that every later mode gets the operands it got before ---
    modes += _wide_modes(torch.Generator().manual_seed(64), check, check_bf16)

    # ---- E: dcn_0/1/2 from the raw heads, serving and gate shapes --------
    for mode, (c, hw, calls) in {
        f"per-tap G=8 D=8 (1,32,{q[0]},{q[1]}) serving, dcn_fused": (MID, q, 0),
        f"per-tap G=8 D=8 (1,32,{gq[0]},{gq[1]}) gate": (MID, gq, 3),
        f"per-tap G=8 D=8 (1,16,{q[0]},{q[1]}) serving mid16": (16, q, 0),
    }.items():
        o = c
        g, d, mag = 8, 8, 10.0
        x = randn(1, c, *hw)
        # white-noise heads saturate tanh and the clip; the smooth ones are
        # what the model's head convolutions produce. Anisotropic flow.
        raw_n, rawm_n = randn(1, g * 18, *hw, std=0.7), randn(1, g * 9, *hw, std=2.0)
        raw_s = smooth(g * 18, hw, 0.3) + randn(1, g * 18, *hw, std=0.02)
        rawm_s = smooth(g * 9, hw, 1.5)
        flow = smooth(2, hw, 3.0) + torch.tensor([2.0, -1.0], device=dev).view(1, 2, 1, 1)
        wt = randn(o, c, 3, 3, std=0.1)
        b = randn(o)
        kw = dict(max_residue_magnitude=mag, max_displacement=d)
        err = 0.0
        for r_, m_ in ((raw_n, rawm_n), (raw_s, rawm_s)):
            ref = deform_conv2d_fusedprep_ref(x, r_, m_, flow, wt, b, **kw)
            got = dcn_fused.deform_conv2d_fusedprep(x, r_, m_, flow, wt, b, **kw)
            torch.cuda.synchronize()
            err = max(err, check("kernel E", mode, 1e-4 * float(ref.abs().max()), got, ref))
        # against the PyTorch prologue, then kernel A, on a smooth field
        yy = torch.arange(hw[0], device=dev).view(1, 1, -1, 1)
        xx = torch.arange(hw[1], device=dev).view(1, 1, 1, -1)
        fr = torch.linspace(-0.3, 0.3, c, device=dev).view(1, c, 1, 1)
        xs = torch.sin(yy * fr + xx * fr.flip(1) + 10 * fr).contiguous()

        def prologue_a(x_, r_, m_):
            off, mask = fusedprep_offsets_and_mask(r_, m_, flow, mag)
            return dcn.deform_conv2d_windowed(x_, off, mask, wt, b, max_displacement=d)

        got = dcn_fused.deform_conv2d_fusedprep(xs, raw_s, rawm_s, flow, wt, b, **kw)
        torch.cuda.synchronize()
        err_pa = check("kernel E", mode + " vs prologue + A", 1e-5, got,
                       prologue_a(xs, raw_s, rawm_s))
        # bf16 x and heads against the f32 plain version on the same values
        xb, rb, mb = (t.to(torch.bfloat16) for t in (x, raw_s, rawm_s))
        refb = deform_conv2d_fusedprep_ref(xb.float(), rb.float(), mb.float(), flow,
                                           wt, b, **kw)
        gotb = dcn_fused.deform_conv2d_fusedprep(xb, rb, mb, flow, wt, b, **kw)
        torch.cuda.synchronize()
        rel = check_bf16("kernel E", mode, gotb, refb)
        # the same rounded offsets through A: the same bits in bf16
        if not torch.equal(gotb, prologue_a(xb, rb, mb)):
            fail(f"kernel E {mode}: bf16 differs from the PyTorch prologue + kernel A")
        if not torch.equal(captured(lambda: dcn_fused.deform_conv2d_fusedprep(
                xb, rb, mb, flow, wt, b, **kw)), gotb):
            fail(f"kernel E {mode}: replayed from a CUDA graph it differs from the eager call")
        k_ms = measure(lambda: dcn_fused.deform_conv2d_fusedprep(xb, rb, mb, flow, wt, b,
                                                                 **kw))
        pa_ms = measure(lambda: prologue_a(xb, rb, mb))
        p_ms = measure(lambda: deform_conv2d_fusedprep_ref(xb, rb, mb, flow, wt, b, **kw),
                       iters=5)
        n_px = hw[0] * hw[1]
        # contraction + samples + the prologue (two tanh, a sigmoid, the
        # flow add and the clip per group and tap, ~40 operations)
        flops = 2 * n_px * c * 9 * o + 9 * n_px * c * 9 + 40 * n_px * g * 9
        bnd = bound([xb, rb, mb, flow, wt, b], [gotb], flops, "bfloat16")
        record("dcn_fused", mode, calls, err, rel, k_ms, p_ms, None, bnd,
               prologue_a_ms=pa_ms[0], prologue_a_device_ms=pa_ms[1],
               max_abs_err_vs_prologue_a=err_pa, bf16_equal_to_prologue_a=True,
               bound_fraction=bnd[0] / k_ms[1], digest=digest(got, gotb))

    # ---- B: HR state (D=32) and the concatenated lv states (D=8); with no
    # clamp (D None) the variants' lv3_state and basic_fvsr's four stacked
    # states at the gate's shapes, whose flow is drawn at +-8. The unclamped
    # modes draw from a generator of their own, so that every later mode
    # gets the operands it got before they were added ----------------------
    own_b = torch.Generator().manual_seed(8)
    for mode, (c, hw, d, calls) in {
        "HR D=32 (1,4,720,720)": (MID // 8, WARP, 32, 1),
        "lv D=8 (1,24,180,180)": (3 * MID // 4, q, 8, 1),
        f"HR D=32 (1,4,{ghr[0]},{ghr[1]}) gate": (MID // 8, ghr, 32, 0),
        f"lv3_state D=8 (1,32,{gq[0]},{gq[1]}) gate": (MID, gq, 8, 0),
        f"lv D=8 (1,24,{gq[0]},{gq[1]}) gate": (3 * MID // 4, gq, 8, 0),
        f"lv3_state unclamped (1,32,{gq[0]},{gq[1]}) variants": (MID, gq, None, 0),
        f"stack unclamped (1,128,{gq[0]},{gq[1]}) basic_fvsr": (4 * MID, gq, None, 0),
        # the gen-1 pyramids' level states (X8's lv2 and lv3, X4's lv2 and
        # lv3 a level down) and a frame of the flow-warp evaluation's call
        # (5 of them a call), all unclamped
        f"pyramid lv2 unclamped (1,64,{ghr[0] // 2},{ghr[1] // 2})": (64, (ghr[0] // 2,
                                                                        ghr[1] // 2), None, 0),
        f"pyramid lv3 unclamped (1,64,{ghr[0]},{ghr[1]})": (64, ghr, None, 0),
        f"flow_warp_eval unclamped (1,3,{ghr[0]},{ghr[1]})": (3, ghr, None, 0),
    }.items():
        amp, g_ = (8, own_b) if d is None else (d, gen)
        x = torch.randn(1, c, *hw, generator=g_).to(dev)
        noisy = (torch.randn(1, 2, *hw, generator=g_) * (0.75 * amp)).to(dev)
        flow = _smooth(g_, 2, hw, amp)
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
        if not torch.equal(captured(lambda: warp.flow_warp_windowed(xb, flow, d)), gotb):
            fail(f"kernel B {mode}: replayed from a CUDA graph it differs from the eager call")
        k_ms = measure(lambda: warp.flow_warp_windowed(xb, flow, d))
        p_ms = measure(lambda: flow_warp_windowed_ref(xb, flow, d), iters=5)
        # yardstick: grid_sample on a precomputed normalised grid (bf16, as
        # grid_sample takes the grid in x's type)
        h, w = hw
        fc = flow if d is None else flow.clamp(-d, d)
        gx = (torch.arange(w, device=dev).view(1, 1, w) + fc[:, 0]) * (2.0 / (w - 1)) - 1
        gy = (torch.arange(h, device=dev).view(1, h, 1) + fc[:, 1]) * (2.0 / (h - 1)) - 1
        grid = torch.stack([gx, gy], dim=-1).to(torch.bfloat16)
        lib_ms = measure(lambda: F.grid_sample(xb, grid, mode="bilinear",
                                               padding_mode="zeros",
                                               align_corners=True))
        # what the card does at this size: a device copy that moves as many
        # bytes as the bound counts (half read, half written)
        half = (xb.numel() * 2 * 2 + flow.numel() * 4) // 2
        src = torch.empty(half, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ms = device_time_ms(lambda: dst.copy_(src))
        record("flow_warp", mode, calls, err, rel, k_ms, p_ms, lib_ms,
               bound([xb, flow], [gotb], 8 * h * w * c, "bfloat16"),
               copy_device_ms=copy_ms, digest=digest(got, gotb))

    # ---- C: r=1 (main path) and r=4 (the s2d frame); the pixel route at a
    # width that is not a multiple of 8 and on y read through a view offset
    # by one element (misaligned), which must give the row route's bits.
    # The last two draw from a generator of their own, so that every later
    # mode gets the operands it got before they were added -----------------
    own = torch.Generator().manual_seed(7)
    for mode, (r, hw, lr_hw, offset, calls, g_) in {
        f"r=1 (1,3,{HR_HW[0]},{HR_HW[1]})": (1, HR_HW, LR_HW, False, 1, gen),
        f"r=4 (1,48,{HR_HW[0] // 4},{HR_HW[1] // 4})": (4, HR_HW, LR_HW, False, 0, gen),
        "r=1 W%8=6 (1,3,270,486)": (1, (270, 486), (34, 61), False, 0, own),
        f"r=1 offset view (1,3,{HR_HW[0]},{HR_HW[1]})": (1, HR_HW, LR_HW, True, 0, own),
        # the gen-1 pyramids' frames from LR 90x160: X8 and X4
        f"r=1 (1,3,{ghr[0]},{ghr[1]}) pyramid X8": (1, ghr, GATE_LR_HW, False, 0, own),
        f"r=1 (1,3,{ghr[0] // 2},{ghr[1] // 2}) pyramid X4": (1, (ghr[0] // 2, ghr[1] // 2),
                                                              GATE_LR_HW, False, 0, own),
    }.items():
        y = torch.randn(1, 3 * r * r, hw[0] // r, hw[1] // r, generator=g_).to(dev)
        lr = torch.rand(1, 3, *lr_hw, generator=g_).to(dev)
        yb, lrb = y.to(torch.bfloat16), lr.to(torch.bfloat16)
        if offset:
            aligned = emit.emit_frame(y, lr), emit.emit_frame(yb, lrb)
            y, yb = (torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view_as(t)
                     .copy_(t) for t in (y, yb))
        ref = emit.emit_frame_ref(y, lr, r)
        got = emit.emit_frame(y, lr, r)
        torch.cuda.synchronize()
        err = check("kernel C", mode, 1e-5, got, ref)
        gotb = emit.emit_frame(yb, lrb, r)
        torch.cuda.synchronize()
        rel = check_bf16("kernel C", mode, gotb, ref)
        plans = [emit.emit_plan(1, 3, *hw, r, t.dtype, t.data_ptr(), o.data_ptr(), lr_hw[1])
                 for t, o in ((y, got), (yb, gotb))]
        # the main path's frame takes the row route in both types
        if calls and not all(p.vector for p in plans):
            fail(f"kernel C {mode}: the main path's frame takes the pixel route {plans}")
        if offset and (any(p.vector for p in plans)
                       or not (torch.equal(got, aligned[0]) and torch.equal(gotb, aligned[1]))):
            fail(f"kernel C {mode}: the pixel route {plans} differs from the row route")
        if not (torch.equal(emit.emit_frame(yb, lrb, r), gotb)
                and torch.equal(captured(lambda: emit.emit_frame(yb, lrb, r)), gotb)):
            fail(f"kernel C {mode}: two runs and a CUDA-graph replay are not bit-equal")
        k_ms = measure(lambda: emit.emit_frame(yb, lrb, r))
        p_ms = measure(lambda: emit.emit_frame_ref(yb, lrb, r), iters=5)
        bnd = bound([yb, lrb], [gotb], 10 * hw[0] * hw[1] * 3, "bfloat16")
        record("emit", mode, calls, err, rel, k_ms, p_ms, None, bnd,
               bound_fraction=bnd[0] / k_ms[1],
               route="row" if plans[1].vector else "pixel", digest=digest(got, gotb))
    return modes


# A at O = 64: (mode, (channels a group, plane, calls per steady frame of
# the X8 plain pyramid at phase 3d's 720p clip)). X8 plain runs CPG 4 at
# (1,64,90,160) and (1,64,180,320), 16 at (1,64,360,640), 64 at
# (1,64,720,1280); X8 CRA CPG 64 at all four; X4 CPG 4 x2, 16, 64 a level
# down; PCD CPG 8 at (1,64,180,320), /2, /4 and its cascade.
WIDE_MODES = {
    "per-tap G=16 (1,64,180,320) cpg4": (4, (180, 320), 1),
    "per-tap G=8 (1,64,180,320) cpg8 pcd": (8, (180, 320), 0),
    "per-tap G=4 (1,64,360,640) cpg16": (16, (360, 640), 1),
    "per-tap G=1 (1,64,720,1280) cpg64": (64, (720, 1280), 1),
}


def _wide_modes(gen, check, check_bf16):
    """Phase 2's records of kernel A at O = 64: f32 to 1e-4 abs against the
    plain version (white-noise and smooth offsets at D = 8, white noise
    unclamped), bf16 to 2e-2 of max|ref| clamped and unclamped, the same
    bits in two runs and from a CUDA-graph replay; timed in bf16 unclamped
    (the pyramids' default), with the f32 kernel's device time beside it.
    The bound takes the larger of the bytes at 3.35 TB/s and the
    contraction's 2 * 9 * C * O FLOP a pixel at the bf16 tensor-core peak;
    ``f32_ops_ms`` is the same FLOP at the f32 CUDA-core peak, the rate of
    the path this first design runs."""
    import torch

    from crfp_torch.ops.cuda import dcn
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    out = []

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    c = o = 64
    d = 8
    for mode, (cpg, hw, calls) in WIDE_MODES.items():
        g = c // cpg
        x = randn(1, c, *hw)
        noisy = randn(1, g * 18, *hw, std=0.75 * d)
        off = _smooth(gen, 2, hw, d).repeat(1, g * 9, 1, 1) + randn(1, g * 18, *hw, std=2.0)
        mask = torch.rand(1, g * 9, *hw, generator=gen).cuda()
        wt = randn(o, c, 3, 3, std=0.05)
        b = randn(o)
        xb = x.to(torch.bfloat16)
        err, rel, bits = 0.0, 0.0, []
        for md in (d, None):
            kw = dict(max_displacement=md)
            for o_ in ((noisy, off) if md is not None else (noisy,)):
                ref = deform_conv2d_windowed_ref(x, o_, mask, wt, b, **kw)
                got = dcn.deform_conv2d_windowed(x, o_, mask, wt, b, **kw)
                torch.cuda.synchronize()
                err = max(err, check("kernel A", f"{mode} D={md}", 1e-4, got, ref))
                bits.append(got)
            refb = deform_conv2d_windowed_ref(xb.float(), off, mask, wt, b, **kw)
            gotb = dcn.deform_conv2d_windowed(xb, off, mask, wt, b, **kw)
            torch.cuda.synchronize()
            rel = max(rel, check_bf16("kernel A", f"{mode} D={md}", gotb, refb))
            for fn_x in (x, xb):
                first = dcn.deform_conv2d_windowed(fn_x, off, mask, wt, b, **kw)
                if not torch.equal(first, dcn.deform_conv2d_windowed(fn_x, off, mask, wt, b,
                                                                      **kw)):
                    fail(f"kernel A {mode} D={md}: two runs on the same inputs differ")
                if not torch.equal(captured(lambda: dcn.deform_conv2d_windowed(
                        fn_x, off, mask, wt, b, **kw)), first):
                    fail(f"kernel A {mode} D={md}: replayed from a CUDA graph it differs")
            bits.append(gotb)
        k_ms = measure(lambda: dcn.deform_conv2d_windowed(xb, off, mask, wt, b))
        f32_dev = device_time_ms(lambda: dcn.deform_conv2d_windowed(x, off, mask, wt, b),
                                 launches=5)
        p_ms = measure(lambda: deform_conv2d_windowed_ref(xb, off, mask, wt, b), iters=3)
        n_px = hw[0] * hw[1]
        flops = 2 * n_px * 9 * c * o
        bnd = bound([xb, off, mask, wt, b], [gotb], flops, "bfloat16")
        f32_ops = flops / PEAK_FLOPS["float32"] * 1e3
        plan = dcn.tile_plan(1, c, *hw, o, g, None, bf16=True)
        _record(out, "dcn_fwd", mode, 0, err, rel, k_ms, p_ms, None, bnd,
                calls_per_x8_frame=calls, f32_device_ms=f32_dev, f32_ops_ms=f32_ops,
                bound_fraction=bnd[0] / k_ms[1], f32_ops_fraction=f32_ops / f32_dev,
                tile=f"{plan.tile_h}x{plan.tile_w} pad {plan.pad}",
                digest=digest(*bits))
    return out



def _zero_counts() -> None:
    from crfp_torch.ops.cuda import dcn, dcn_fused, emit, ssim, warp

    dcn.launches = warp.launches = emit.launches = dcn_fused.launches = 0
    dcn.bwd_launches = warp.bwd_launches = ssim.launches = 0


def _counts() -> dict:
    from crfp_torch.ops.cuda import dcn, dcn_fused, emit, ssim, warp

    return {"dcn_fwd": dcn.launches, "flow_warp": warp.launches,
            "emit": emit.launches, "dcn_bwd": dcn.bwd_launches,
            "flow_warp_bwd": warp.bwd_launches, "dcn_fused": dcn_fused.launches,
            "ssim": ssim.launches}


def _expect(**counts) -> dict:
    """A full launch-count dict: the kernels named, every other one 0."""
    return {**dict.fromkeys(_counts(), 0), **counts}


def _train_expect(steps: int, dcns: int = 4, warps: int = 3) -> dict:
    """Kernel launches of ``steps`` train steps at the recipe: T-1 recurrent
    steps of ``dcns`` DCNs and ``warps`` warps each (v18: 4 and 3), run
    twice forward (remat recomputes each step in the backward pass) and
    once backward; two SSIM metrics; no frame emission in the batch trunk."""
    from crfp_torch.bench.train import RECIPE

    n_rec = RECIPE["t"] - 1
    per_step = _expect(dcn_fwd=2 * dcns * n_rec, flow_warp=2 * warps * n_rec,
                       dcn_bwd=dcns * n_rec, flow_warp_bwd=warps * n_rec, ssim=2)
    return {k: v * steps for k, v in per_step.items()}


def _frames_agree(tag, got, want, db_min=80.0, d_max=1e-3, shape=None,
                  versus="kernels vs plain"):
    """Each frame through the kernels against the same frame through the
    plain versions (or as ``versus`` names them): finite, PSNR >=
    ``db_min`` and max|d| <= ``d_max`` (None: not held)."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        if (shape is not None and g.shape != shape) or not bool(torch.isfinite(g).all()):
            fail(f"{tag} frame {i}: shape {tuple(g.shape)} or non-finite values")
        d = (g - w).abs()
        mse = float((d.double() ** 2).mean())
        psnr = math.inf if mse == 0 else 10 * math.log10(1.0 / mse)
        print(f"{tag} frame {i}: {versus} PSNR {psnr:.2f} dB (limit >= {db_min:g}), "
              f"max|d| {float(d.max()):.3e}, frame range "
              f"[{float(g.min()):.3f}, {float(g.max()):.3f}]")
        if not (psnr >= db_min and (d_max is None or float(d.max()) <= d_max)):
            fail(f"{tag} frame {i}: {versus} PSNR {psnr:.2f} dB, "
                 f"max|d| {float(d.max())}")


def phase_slice(mid=MID, ckpt=CKPT):
    """Phase 3 (and the runtime half of phase 3b at mid 16). Returns the
    launch counts of the kernel-path run."""
    import numpy as np
    import torch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.params import from_jax, load_npz, runtime_params_from_batch

    t = 5
    cfg = ModelConfig(mid_channels=mid, dcn_window=8, dcn_window_hr=32)
    model = CRFPRuntimeV18(cfg, warp_size=WARP, device="cuda", seed=0)
    sd, n_unmapped = runtime_params_from_batch(from_jax(load_npz(str(ckpt))),
                                              model.state_dict())
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
    _zero_counts()
    t0 = time.perf_counter()
    got = run()
    wall = time.perf_counter() - t0
    launches = _counts()
    expect = _expect(dcn_fwd=4 * (t - 1), flow_warp=2 * (t - 1), emit=t)
    print(f"[slice] {t} frames 1080p warp {WARP} mid {mid} ({Path(ckpt).name}) f32 via "
          f"kernels in {wall:.3f} s (first run, host clock); launches {launches}")
    if launches != expect:
        fail(f"launch counts {launches} != expected {expect}")
    _frames_agree(f"[slice] mid {mid}", got, want, shape=(1, *HR_HW, 3))
    return launches


def phase_mid16():
    """Phase 3b: checkpoints/v18_mid16_procedural.npz on the card, whose DCN
    stages run A, D and E at O = 16 (2 channels per group) and O = 2. The
    runtime slice of phase 3 at mid 16 (A, B, C), then MID16_FRAMES frames
    of a gate clip through StreamingRunner in f32: EXACT (A 4, B 3 per
    steady frame) and DEPLOY with dcn_fused (E 3, A 1, B 3), each through
    the kernels and through the plain versions (>= 80 dB, max|d| <= 1e-3
    per frame), launch counts asserted."""
    import numpy as np

    from crfp_torch.bench import deploy_gate as dg

    launches = {"runtime": phase_slice(16, MID16_CKPT)}
    lr, hr, gaze = dg.gate_clip(np.random.default_rng(16), 50.0, GATE_LR_HW, MID16_FRAMES)
    steady = MID16_FRAMES - 1
    for tag, kw, expect in (
        ("EXACT f32", dict(deploy=False), _expect(dcn_fwd=4 * steady, flow_warp=3 * steady)),
        ("DEPLOY f32 dcn_fused", dict(deploy=True, dcn_fused=True),
         _expect(dcn_fused=3 * steady, dcn_fwd=steady, flow_warp=3 * steady)),
    ):
        runner = dg.build_runner(str(MID16_CKPT), 16, device="cuda", **kw)
        runner.model.float()
        _zero_counts()
        got = [out for _, out, _ in dg.stream_clip(runner, lr, hr, gaze)]
        launches[tag] = _counts()
        print(f"[mid16] {tag}: {MID16_FRAMES} frames of a gate clip, launches {launches[tag]}")
        if launches[tag] != expect:
            fail(f"mid-16 {tag}: launch counts {launches[tag]} != expected {expect}")
        with plain_kernels():
            want = [out for _, out, _ in dg.stream_clip(runner, lr, hr, gaze)]
        _frames_agree(f"[mid16] {tag}", got, want, shape=(1, *hr.shape[1:3], 3))
    return launches


# Phase 3c: the trunk variants beside v18. The two that have trained mid-32
# weights (hr_dcn=False, their only branch), with the A and B launches of a
# steady frame; then seeded random weights for the rest.
VARIANT_CKPTS = {
    "basic_fvsr": (ROOT / "checkpoints" / "basic_fvsr_mid32_struct.npz", 4, 1),
    "no_dcn": (ROOT / "checkpoints" / "no_dcn_mid32_struct.npz", 0, 1),
}
RANDOM_VARIANTS = [
    ("v13", dict(variant="v13"), 4, 1),
    ("v13 hr_dcn=False", dict(variant="v13", hr_dcn=False), 4, 1),
    ("v15", dict(variant="v15"), 4, 1),
    ("v15 hr_dcn=False", dict(variant="v15", hr_dcn=False), 4, 1),
    ("v18_cra", dict(variant="v18_cra"), 4, 3),
    ("v18 y_only", dict(variant="v18", y_only=True), 4, 3),
]
VARIANT_FRAMES, RANDOM_FRAMES, WARM_FRAMES, TIMED_FRAMES = 4, 3, 2, 6


@functools.cache
def _variant_clip(frames: int):
    """``frames`` frames of phase 3b's 720p gate clip on the card: lr, hr
    (the fovea frames; the masks gate them) and the masks of its gazes."""
    import numpy as np
    import torch

    from crfp_torch.bench import deploy_gate as dg
    from crfp_torch.eval.zones import zone_masks_step

    lr, hr, gaze = dg.gate_clip(np.random.default_rng(16), 50.0, GATE_LR_HW, frames)
    masks = np.stack([zone_masks_step(*hr.shape[1:3], tuple(g), dg.FV_SIZE).mask
                      for g in gaze])
    return tuple(torch.from_numpy(a).cuda() for a in (lr, hr, masks))


def _variant_model(fields, ckpt=None, seed=0, dtype=None, **cfg):
    """The trunk of ``fields`` at mid 32, windows 8/32, on the card: the
    checkpoint loaded strictly, or the seeded init with random offset/mask
    heads and DCN weights (the init's zero heads would leave every DCN at
    the flow with mask 0.5)."""
    import torch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, load_npz

    model = CRFP(ModelConfig(mid_channels=MID, dcn_window=8, dcn_window_hr=32, **fields,
                             **cfg), device="cuda", seed=seed)
    if ckpt is not None:
        model.load_state_dict(from_jax(load_npz(str(ckpt))), strict=True)
    else:
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if any(k in name for k in (".dcn_offset.", ".dcn_mask.", ".dcn_weight",
                                           ".dcn_bias")):
                    std = 0.05 if ".dcn_offset." in name else 0.2
                    p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model.to(dtype or torch.float32).eval()


def _stream_variant(model, frames: int):
    """The first ``frames`` frames of the variants' clip through
    StreamingRunner as float32 tensors on the card (the model's windows,
    8/32, and the JAX trunk's unclamped warps where the variant has them)."""
    import torch

    from crfp_torch.models.streaming import StreamingRunner

    lr, hr, masks = _variant_clip(VARIANT_FRAMES if frames <= VARIANT_FRAMES else frames)
    runner = StreamingRunner(model)
    outs = [runner(lr[i][None], hr[i][None], masks[i][None]).float() for i in range(frames)]
    torch.cuda.synchronize()
    return outs


def _variant_vs_plain(tag, model, frames, a_per, b_per, total):
    """Stream through the kernels, assert the launches (``a_per`` A and
    ``b_per`` B per steady frame), then through the plain versions: >= 80
    dB and max|d| <= 1e-3 per frame. Adds the kernel run's launches to
    ``total``."""
    steady = frames - 1
    _zero_counts()
    got = _stream_variant(model, frames)
    launches = _counts()
    want_counts = _expect(dcn_fwd=a_per * steady, flow_warp=b_per * steady)
    print(f"[variants] {tag}: {frames} frames, launches {launches}")
    if launches != want_counts:
        fail(f"variants {tag}: launch counts {launches} != expected {want_counts}")
    for k, v in launches.items():
        total[k] += v
    with plain_kernels():
        want = _stream_variant(model, frames)
    out_c = model.conv_last.conv.out_channels
    _frames_agree(f"[variants] {tag}", got, want,
                  shape=(1, GATE_LR_HW[0] * 8, GATE_LR_HW[1] * 8, out_c))


def _time_variants(configs) -> dict:
    """ms per steady bf16 frame of each (tag, model) of ``configs`` over
    TIMED_FRAMES frames after a cold start and WARM_FRAMES steady frames,
    CUDA events; every configuration twice, in order and in reverse, as the
    host's speed drifts within a call (the first frames of a new shape
    also load its convolution kernels)."""
    import torch

    from crfp_torch.models.streaming import StreamingRunner

    warm = 1 + WARM_FRAMES
    n = warm + TIMED_FRAMES
    lr, hr, masks = _variant_clip(n)
    ms = {tag: [] for tag, _ in configs}
    for tag, model in list(configs) + list(reversed(configs)):
        runner = StreamingRunner(model)
        for i in range(warm):
            runner(lr[i][None], hr[i][None], masks[i][None])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for i in range(warm, n):
            runner(lr[i][None], hr[i][None], masks[i][None])
        end.record()
        torch.cuda.synchronize()
        ms[tag].append(start.elapsed_time(end) / TIMED_FRAMES)
    return ms


def phase_variants():
    """Phase 3c. Returns the launch counts over the phase's kernel runs."""
    import torch

    from crfp_torch.bench.train import build_trainer

    total = _expect()
    steady = VARIANT_FRAMES - 1
    bf16 = torch.bfloat16
    t0 = time.perf_counter()

    def lap(block):
        nonlocal t0
        print(f"[variants] {block} in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    # serving, on the trained weights: f32 kernels against plain versions,
    # then basic_fvsr in bf16 with dcn_fused against bf16 without it
    for variant, (ckpt, a_per, b_per) in VARIANT_CKPTS.items():
        fields = dict(variant=variant, hr_dcn=False)
        _variant_vs_plain(f"{variant} ({ckpt.name}) f32", _variant_model(fields, ckpt),
                          VARIANT_FRAMES, a_per, b_per, total)
    fields, (ckpt, _, _) = dict(variant="basic_fvsr", hr_dcn=False), VARIANT_CKPTS["basic_fvsr"]
    runs = {}
    for fused, expect in ((True, _expect(dcn_fused=3 * steady, dcn_fwd=steady,
                                         flow_warp=steady)),
                          (False, _expect(dcn_fwd=4 * steady, flow_warp=steady))):
        _zero_counts()
        runs[fused] = _stream_variant(_variant_model(fields, ckpt, dtype=bf16,
                                                     dcn_fused=fused), VARIANT_FRAMES)
        launches = _counts()
        print(f"[variants] basic_fvsr bf16 dcn_fused={fused}: launches {launches}")
        if launches != expect:
            fail(f"variants basic_fvsr bf16 dcn_fused={fused}: launch counts {launches} "
                 f"!= expected {expect}")
        for k, v in launches.items():
            total[k] += v
    _frames_agree("[variants] basic_fvsr bf16", runs[True], runs[False], db_min=60.0,
                  d_max=None, versus="dcn_fused vs structured")
    lap("serving on the checkpoints")

    # serving, on seeded random weights
    for i, (tag, fields, a_per, b_per) in enumerate(RANDOM_VARIANTS):
        _variant_vs_plain(f"{tag} (seeded) f32", _variant_model(fields, seed=100 + i),
                          RANDOM_FRAMES, a_per, b_per, total)
    lap("serving on seeded weights")

    # training at the recipe from the checkpoints: f32 kernels against
    # plain versions (launches asserted), then amp steps that must stay finite
    lr = 2e-4
    for variant, steps, (dcns, warps) in (("basic_fvsr", 3, (4, 1)), ("no_dcn", 2, (0, 1))):
        ckpt = str(VARIANT_CKPTS[variant][0])
        batches = _train_batches()
        got = _train_vs_plain(f"[variants] {variant} train", steps, lr,
                              _train_expect(steps, dcns, warps), batches, ckpt=ckpt,
                              variant=variant)
        _zero_counts()
        _, opt, step = build_trainer(amp=True, ckpt=ckpt, lr_rate=lr, variant=variant)
        amp_losses = [float(step(opt, batches[0], i)["loss"]) for i in range(5)]
        launches = _counts()
        print(f"[variants] {variant} amp losses on one batch from the checkpoint: {amp_losses}; "
              f"launches {launches}")
        if not all(math.isfinite(v) for v in amp_losses):
            fail(f"variants {variant}: amp steps gave non-finite losses {amp_losses}")
        if launches != _train_expect(5, dcns, warps):
            fail(f"variants {variant}: amp launch counts {launches} != "
                 f"{_train_expect(5, dcns, warps)}")
        for k in total:
            total[k] += got[k] + launches[k]
    lap("training")

    # ms per steady bf16 frame of every variant and of v18, in one call
    configs = [("v18", _variant_model(dict(variant="v18"), GATE_CKPT, dtype=bf16))]
    configs += [(tag, _variant_model(fields, seed=100 + i, dtype=bf16))
                for i, (tag, fields, _, _) in enumerate(RANDOM_VARIANTS)]
    configs += [(variant, _variant_model(dict(variant=variant, hr_dcn=False), ckpt,
                                         dtype=bf16))
                for variant, (ckpt, _, _) in VARIANT_CKPTS.items()]
    configs.append(("basic_fvsr dcn_fused", _variant_model(
        dict(variant="basic_fvsr", hr_dcn=False), VARIANT_CKPTS["basic_fvsr"][0],
        dtype=bf16, dcn_fused=True)))
    ms = _time_variants(configs)
    lap("timing")
    print(f"[variants] ms per steady bf16 frame at LR {GATE_LR_HW} -> "
          f"{GATE_LR_HW[0] * 8}x{GATE_LR_HW[1] * 8}, mid {MID}, windows 8/32, "
          f"{TIMED_FRAMES} frames, CUDA events, in order, reversed: "
          f"{json.dumps(ms)}")
    print(f"[variants] launches over the phase's kernel runs: {total}")
    return total


# Phase 3d: the models beside the trunk: the runtime variants, the trunk
# with SPyNet, the flow-warp evaluation, the gen-1 pyramids and PCD.
MODEL_FRAMES, PYR_FRAMES, PYR_MID = 4, 3, 64
PYR_TIMED = (3, 5)  # clip lengths: their time difference over 2 is a steady frame
RUNTIME_SIMPLE = ("v13", "v15")


def _perturb_dcn(model, seed: int, offset_std: float = 0.05):
    """Random offset/mask heads and DCN weights, biases from ``seed``: every
    parameter whose path has a part starting dcn_offset (std
    ``offset_std``), dcn_mask, dcn_weight or dcn_bias (std 0.2); the init's
    zero heads would leave every DCN at the flow with mask 0.5."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            if any(q.startswith("dcn_offset") for q in parts):
                std = offset_std
            elif any(q.startswith(("dcn_mask", "dcn_weight", "dcn_bias")) for q in parts):
                std = 0.2
            else:
                continue
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model


def _runtime_model(kind: str, dtype=None):
    """A runtime model at mid 32, windows 8/32, warp 720^2 on the card:
    CRFPRuntimeSimple v13/v15 and v18 from seeds with random heads, v18
    nofv from checkpoints/v18_mid32_struct.npz."""
    import torch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeSimple, CRFPRuntimeV18
    from crfp_torch.params import from_jax, load_npz, runtime_params_from_batch

    win = dict(mid_channels=MID, dcn_window=8, dcn_window_hr=32)
    if kind in RUNTIME_SIMPLE:
        model = _perturb_dcn(CRFPRuntimeSimple(ModelConfig(variant=kind, **win), WARP,
                                               device="cuda", seed=30), 31)
    elif kind == "v18 nofv":
        model = CRFPRuntimeV18(ModelConfig(**win), WARP, nofv=True, device="cuda")
        sd, n_unmapped = runtime_params_from_batch(from_jax(load_npz(str(CKPT))),
                                                  model.state_dict())
        if n_unmapped != 5:
            fail(f"nofv: the checkpoint adapter kept {n_unmapped} leaves at init, expected 5")
        model.load_state_dict(sd, strict=True)
    else:
        model = _perturb_dcn(CRFPRuntimeV18(ModelConfig(**win), WARP, device="cuda", seed=30),
                             31)
    return model.to(dtype or torch.float32).eval()


def _runtime_frames(model, lrs, fvs, frames):
    """``frames`` frames through encode / step0 / step; fvs None: nofv."""
    import torch

    outs = []
    with torch.inference_mode():
        for i in range(frames):
            x_lr, x_hr = model.encode(lrs[i], None if fvs is None else fvs[i])
            if i == 0:
                state, out = model.step0(lrs[i], x_lr, x_hr)
            else:
                state, out = model.step(state, lrs[i], lrs[i - 1], x_lr, x_hr)
            outs.append(out.float())
    torch.cuda.synchronize()
    return outs


def _runtime_clip(frames: int, dtype=None):
    import numpy as np
    import torch

    rng = np.random.default_rng(30)
    lrs = torch.from_numpy(rng.uniform(0, 1, (frames, 1, *LR_HW, 3)).astype(np.float32))
    fvs = torch.from_numpy(rng.uniform(0, 1, (frames, 1, FV, FV, 3)).astype(np.float32))
    dtype = dtype or torch.float32
    return lrs.to("cuda", dtype), fvs.to("cuda", dtype)


def _pyramid(kind: str, cra: bool, window=None, dtype=None):
    """X8 or X4 at mid 64, dg 16 on the card, seeded, with random heads."""
    import torch

    from crfp_torch.models.pyramid import CRFPPyramidX4, CRFPPyramidX8

    cls = CRFPPyramidX8 if kind == "X8" else CRFPPyramidX4
    model = cls(PYR_MID, cra=cra, dg_num=16, dcn_window=window, device="cuda", seed=40)
    # offset heads of std 0.5: 10 tanh(raw) + flow passes D = 8 for 3-11 % of
    # the offsets (0.05 leaves them within +-7), so that the clamped X8
    # differs from the unclamped one
    return _perturb_dcn(model, 41, offset_std=0.5).to(dtype or torch.float32).eval()


def _pyramid_inputs(kind: str, cra: bool, frames: int, dtype=None):
    """(lrs, fvs[, mks]) NHWC clips of phase 3c's 720p clip: X8 the 720x1280
    frames and masks (CRA: the top-left 96x96 fovea patch, no masks); X4
    the frames resized to 360x640 and the masks taken every other pixel."""
    import torch
    import torch.nn.functional as F

    # phase 3c's timing clip, made once (its first frames are every shorter clip)
    lr, hr, masks = _variant_clip(max(frames, 1 + WARM_FRAMES + TIMED_FRAMES))
    lr, hr, masks = lr[:frames], hr[:frames], masks[:frames].float()
    if kind == "X8":
        args = (lr, hr[:, :FV, :FV]) if cra else (lr, hr, masks)
    else:
        hr4 = F.interpolate(hr.permute(0, 3, 1, 2), size=(hr.shape[1] // 2, hr.shape[2] // 2),
                            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        args = (lr, hr4, masks[:, ::2, ::2])
    return tuple(a[None].to(dtype or torch.float32).contiguous() for a in args)


def _models_vs_plain(tag, run, expect, total, shape):
    """``run()`` through the kernels (launch counts equal to ``expect``),
    then through the plain versions: >= 80 dB and max|d| <= 1e-3 per frame.
    Adds the kernel run's launches to ``total``; returns the kernels' frames."""
    _zero_counts()
    got = run()
    launches = _counts()
    print(f"[models] {tag}: launches {launches}")
    if launches != expect:
        fail(f"models {tag}: launch counts {launches} != expected {expect}")
    for k, v in launches.items():
        total[k] += v
    with plain_kernels():
        want = run()
    _frames_agree(f"[models] {tag}", got, want, shape=shape)
    return got


def phase_models():
    """Phase 3d. Returns the launch counts over the phase's kernel runs."""
    import numpy as np
    import torch

    from crfp_torch.bench import deploy_gate as dg
    from crfp_torch.bench.train import build_trainer
    from crfp_torch.eval.flow_warp_eval import flow_warp_propagation_eval
    from crfp_torch.nn.pcd import PCDAlign
    from crfp_torch.ops.cuda import dcn

    total = _expect()
    bf16 = torch.bfloat16
    t0 = time.perf_counter()

    def lap(block):
        nonlocal t0
        print(f"[models] {block} in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    # the runtime variants at 1080p / warp 720^2, f32: A 4 a steady frame,
    # B 1 (CRFPRuntimeSimple: the HR state only) or 2 (nofv), C 1 a frame
    steady = MODEL_FRAMES - 1
    lrs, fvs = _runtime_clip(MODEL_FRAMES)
    for kind, b_per in (("v13", 1), ("v15", 1), ("v18 nofv", 2)):
        model = _runtime_model(kind)
        clip_fv = None if kind == "v18 nofv" else fvs
        _models_vs_plain(f"runtime {kind} f32",
                         lambda: _runtime_frames(model, lrs, clip_fv, MODEL_FRAMES),
                         _expect(dcn_fwd=4 * steady, flow_warp=b_per * steady,
                                 emit=MODEL_FRAMES), total, (1, *HR_HW, 3))
    lap("runtime variants")

    # the v18 trunk with flow_net="spynet": streamed, then trained
    model = _variant_model(dict(variant="v18", flow_net="spynet"), seed=50)
    _variant_vs_plain("v18 spynet (seeded) f32", model, RANDOM_FRAMES, 4, 3, total)
    lr_rate = 2e-4
    batches = _train_batches()
    got = _train_vs_plain("[models] v18 spynet train", 2, lr_rate, _train_expect(2), batches,
                          flow_net="spynet")
    _zero_counts()
    _, opt, step = build_trainer(amp=True, lr_rate=lr_rate, flow_net="spynet")
    amp_losses = [float(step(opt, batches[i], i)["loss"]) for i in range(3)]
    launches = _counts()
    print(f"[models] v18 spynet amp losses from the seeded init: {amp_losses}; "
          f"launches {launches}")
    if not all(math.isfinite(v) for v in amp_losses):
        fail(f"models v18 spynet: amp steps gave non-finite losses {amp_losses}")
    if launches != _train_expect(3):
        fail(f"models v18 spynet: amp launch counts {launches} != {_train_expect(3)}")
    for k in total:
        total[k] += got[k] + launches[k]
    lap("spynet trunk")

    # BASELINE config 1 on 6 frames of the 720p clip: B 1, F 5 a call
    lr_np, hr_np, _ = dg.gate_clip(np.random.default_rng(16), 50.0, GATE_LR_HW, 6)
    for net in ("spynet", "fnet"):
        _zero_counts()
        got = flow_warp_propagation_eval(lr_np, hr_np, flow_net=net, device="cuda",
                                         generator=torch.Generator().manual_seed(60))
        launches = _counts()
        if launches != _expect(flow_warp=1, ssim=5):
            fail(f"flow_warp_eval {net}: launch counts {launches}")
        for k, v in launches.items():
            total[k] += v
        with plain_kernels():
            want = flow_warp_propagation_eval(lr_np, hr_np, flow_net=net, device="cuda",
                                              params=got["params"])
        dp = max(abs(a - b) for a, b in zip(got["psnr"], want["psnr"]))
        ds = max(abs(a - b) for a, b in zip(got["ssim"], want["ssim"]))
        print(f"[models] flow_warp_eval {net}: PSNR {got['psnr']} SSIM {got['ssim']}; "
              f"kernels vs plain max|dPSNR| {dp:.3e} dB, max|dSSIM| {ds:.3e}; "
              f"launches {launches}")
        if not (dp <= 1e-3 and ds <= 1e-5 and len(got["psnr"]) == 5):
            fail(f"flow_warp_eval {net}: kernels vs plain dPSNR {dp}, dSSIM {ds}")
    lap("flow-warp eval")

    # the gen-1 pyramids at mid 64, dg 16: X8 A 4, B 4, C 1 a steady frame,
    # X4 A 4, B 3, C 1; the cold frame C 1
    steady = PYR_FRAMES - 1
    frames = {}
    for kind, cra, window in (("X8", False, None), ("X8", False, 8), ("X8", True, None),
                              ("X4", False, None), ("X4", True, None)):
        model = _pyramid(kind, cra, window)
        args = _pyramid_inputs(kind, cra, PYR_FRAMES)
        b_per = 4 if kind == "X8" else 3
        s = 8 if kind == "X8" else 4

        def run(model=model, args=args):
            out = model(*args)  # forward runs under no_grad itself
            torch.cuda.synchronize()
            return list(out.float().unbind(1))

        frames[kind, cra, window] = _models_vs_plain(
            f"{kind}{' CRA' if cra else ''} dcn_window={window} f32", run,
            _expect(dcn_fwd=4 * steady, flow_warp=b_per * steady, emit=PYR_FRAMES), total,
            (1, GATE_LR_HW[0] * s, GATE_LR_HW[1] * s, 3))
        del model
    clamp_d = float((frames["X8", False, 8][-1] - frames["X8", False, None][-1]).abs().max())
    print(f"[models] X8 dcn_window=8 against None, last frame: max|d| {clamp_d:.3e}")
    if not clamp_d > 1e-4:
        fail("X8 dcn_window=8 gave the unclamped frames: the window clamped nothing")
    # the models run under no_grad; a DCN at their width that autograd
    # records raises (kernel D does not take O = 64)
    xg = torch.randn(1, PYR_MID, 16, 16, device="cuda", requires_grad=True)
    try:
        dcn.deform_conv2d_windowed(xg, torch.zeros(1, 18 * 16, 16, 16, device="cuda"),
                                   torch.ones(1, 9 * 16, 16, 16, device="cuda"),
                                   torch.zeros(PYR_MID, PYR_MID, 3, 3, device="cuda"))
        fail("a recorded O = 64 DCN did not raise")
    except ValueError as e:
        if "dcn_bwd" not in str(e):
            raise
        print(f"[models] a recorded O = 64 DCN raises: {e}")
    lap("pyramids")

    # PCD at nf 64, 8 groups: A 4 a call
    pcd = _perturb_dcn(PCDAlign(64, 8, device="cuda", seed=70), 71)
    gen = torch.Generator().manual_seed(72)
    feats = [torch.randn(1, 64, 180, 320, generator=gen).cuda() for _ in range(3)]
    flow = _smooth(gen, 2, (180, 320), 3.0)

    def run_pcd():
        out = pcd(*feats, flow)  # forward runs under no_grad itself
        torch.cuda.synchronize()
        return [out]

    _models_vs_plain("PCD nf 64 groups 8 (1,64,180,320) f32", run_pcd, _expect(dcn_fwd=4),
                     total, (1, 64, 180, 320))
    lap("PCD")

    # ms per steady bf16 frame, CUDA events, every model in order and reversed
    ms = {}
    lrs, fvs = _runtime_clip(3 + TIMED_FRAMES, bf16)
    runtime = [(k, _runtime_model(k, bf16)) for k in ("v18", "v13", "v15", "v18 nofv")]
    for tag, model in runtime + runtime[::-1]:
        clip_fv = fvs if tag != "v18 nofv" else None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            for i in range(3 + TIMED_FRAMES):  # a cold frame, 2 warm, then timed
                if i == 3:
                    start.record()
                x_lr, x_hr = model.encode(lrs[i], None if clip_fv is None else clip_fv[i])
                if i == 0:
                    state, _ = model.step0(lrs[i], x_lr, x_hr)
                else:
                    state, _ = model.step(state, lrs[i], lrs[i - 1], x_lr, x_hr)
            end.record()
        torch.cuda.synchronize()
        ms.setdefault(f"runtime {tag} 1080p", []).append(
            start.elapsed_time(end) / TIMED_FRAMES)
    del runtime
    pyramids = [(f"{k}{' CRA' if c else ''}", k, c, _pyramid(k, c, dtype=bf16))
                for k, c in (("X8", False), ("X8", True), ("X4", False), ("X4", True))]
    for tag, kind, cra, model in pyramids + pyramids[::-1]:
        spans = []
        for frames in PYR_TIMED:
            args = _pyramid_inputs(kind, cra, frames, bf16)
            with torch.inference_mode():
                model(*args)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                model(*args)
                end.record()
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end))
        ms.setdefault(f"pyramid {tag} 720p-LR", []).append(
            (spans[1] - spans[0]) / (PYR_TIMED[1] - PYR_TIMED[0]))
    lap("timing")
    print(f"[models] ms per steady bf16 frame (runtime: 1080p, warp 720^2, mid 32, "
          f"windows 8/32, {TIMED_FRAMES} frames after 3; pyramids: LR {GATE_LR_HW}, mid "
          f"{PYR_MID}, dcn_window None, clip of {PYR_TIMED[1]} frames less clip of "
          f"{PYR_TIMED[0]}, over the difference), CUDA events, in order, reversed: "
          f"{json.dumps(ms)}")
    print(f"[models] launches over the phase's kernel runs: {total}")
    return total



def phase_bench():
    """Phase 4: the 1080p serving bench without and with dcn_fused, in one
    call. Returns {configuration: [ms/frame of each run]}."""
    from crfp_torch.bench.runtime import run_runtime_bench

    t, repeat_time, warm_up = 5, 30, 10
    reps = warm_up + 2 * (repeat_time - warm_up)  # a warm-up and two timed chains
    steady, frames = reps * (t - 1), reps * t
    results = {"structured": [], "dcn_fused": []}
    # in turns (off, on, on, off): the frame is host-bound, and the host's
    # speed drifts within a call
    for fused in (False, True, True, False):
        _zero_counts()
        res = run_runtime_bench(preset="1080p", warp_size=WARP, bf16=True, t=t,
                                repeat_time=repeat_time, warm_up=warm_up,
                                dcn_fused=fused)
        launches = _counts()
        tag = "dcn_fused" if fused else "structured"
        print(f"[bench] {tag}: {res}")
        print(f"[bench] {tag}: launches over {frames} frames ({steady} steady): {launches}")
        expect = (_expect(dcn_fused=3 * steady, dcn_fwd=steady, flow_warp=2 * steady,
                          emit=frames) if fused else
                  _expect(dcn_fwd=4 * steady, flow_warp=2 * steady, emit=frames))
        if launches != expect:
            fail(f"serving bench ({tag}) launch counts {launches} != expected {expect}")
        results[tag].append(res.sec_per_frame * 1e3)
    print(f"[bench] ms/frame in turns: structured {results['structured']}, dcn_fused "
          f"{results['dcn_fused']}")
    return results


def phase_gate():
    """Phase 8: the deployment quality gate at full width. Returns the launch
    counts of the gate's run."""
    import numpy as np
    import torch

    from crfp_torch.bench import deploy_gate as dg

    frames, sigmas = GATE_FRAMES, GATE_SIGMAS
    n_sig, steady = len(sigmas), frames - 1
    _zero_counts()
    t0 = time.perf_counter()
    rows, extras = dg.run_gate(str(GATE_CKPT), sigmas=sigmas, lr_hw=GATE_LR_HW,
                               frames=frames, mid_channels=MID, dcn_fused=True,
                               device="cuda")
    wall = time.perf_counter() - t0
    launches = _counts()
    print(f"[gate] {frames} frames x sigmas {sigmas} at LR {GATE_LR_HW} -> "
          f"{GATE_LR_HW[0] * 8}x{GATE_LR_HW[1] * 8}, mid {MID}, {GATE_CKPT.name}, "
          f"EXACT f32 vs DEPLOY bf16 windows 8/32 dcn_fused: {wall:.2f} s (host clock, "
          "models built and clips generated inside)")
    print(dg.format_table(rows))
    worst = max(abs(r.d_psnr) for r in rows)
    print(f"[gate] worst per-zone |dPSNR| {worst:.4f} dB (limit 0.05); exact-vs-deploy "
          f"agreement per sigma {[round(a, 2) for a in extras['agree_db']]} dB (limit "
          f">= {GATE_AGREE_DB:g}); host-clock ms per steady frame: EXACT "
          f"{extras['exact_ms_per_frame']:.3f}, DEPLOY {extras['deploy_ms_per_frame']:.3f}")
    print(f"[gate] launches: {launches}")
    # EXACT: A 4, B 3 per steady frame; DEPLOY: E 3, A 1, B 3; one F per
    # evaluated frame for each of the two evaluators; the trunk emits no frame
    expect = _expect(dcn_fwd=5 * steady * n_sig, flow_warp=6 * steady * n_sig,
                     dcn_fused=3 * steady * n_sig, ssim=2 * frames * n_sig)
    if launches != expect:
        fail(f"gate launch counts {launches} != expected {expect}")
    if len(rows) != 4 * n_sig:
        fail(f"gate returned {len(rows)} rows, expected {4 * n_sig}")
    for r in rows:
        vals = (r.exact_psnr, r.exact_ssim, r.deploy_psnr, r.deploy_ssim)
        if not all(math.isfinite(v) for v in vals):
            fail(f"gate row {r} is not finite")
        if not abs(r.d_psnr) <= 0.05:
            fail(f"gate sigma {r.sigma} zone {r.zone}: |dPSNR| {abs(r.d_psnr):.4f} > 0.05 dB")
    if not extras["agree_db_min"] >= GATE_AGREE_DB:
        fail(f"gate exact-vs-deploy agreement {extras['agree_db']} dB < {GATE_AGREE_DB:g} dB")

    # each path alone over the first sigma's clip: its launch counts, and
    # DEPLOY with and without dcn_fused against each other
    lr, hr, gaze = dg.gate_clip(np.random.default_rng(42), sigmas[0], GATE_LR_HW, frames)
    outs = {}
    per_path = {
        "EXACT": (dict(deploy=False), _expect(dcn_fwd=4 * steady, flow_warp=3 * steady)),
        "DEPLOY dcn_fused": (dict(deploy=True, dcn_fused=True),
                             _expect(dcn_fused=3 * steady, dcn_fwd=steady,
                                     flow_warp=3 * steady)),
        "DEPLOY structured": (dict(deploy=True, dcn_fused=False),
                              _expect(dcn_fwd=4 * steady, flow_warp=3 * steady)),
    }
    for tag, (kw, expect) in per_path.items():
        runner = dg.build_runner(str(GATE_CKPT), MID, device="cuda", **kw)
        secs = []
        _zero_counts()
        outs[tag] = [out for _, out, _ in dg.stream_clip(runner, lr, hr, gaze, secs)]
        got = _counts()
        print(f"[gate] {tag} alone, {frames} frames: launches {got}; "
              f"{1e3 * sum(secs[1:]) / steady:.3f} ms per steady frame (host clock)")
        if got != expect:
            fail(f"gate path {tag}: launch counts {got} != expected {expect}")
    mse = float(torch.stack([((a - b).double() ** 2).mean() for a, b in
                             zip(outs["DEPLOY dcn_fused"], outs["DEPLOY structured"])]).mean())
    psnr = math.inf if mse == 0 else 10 * math.log10(1.0 / mse)
    print(f"[gate] DEPLOY dcn_fused vs DEPLOY structured over sigma {sigmas[0]:g}: "
          f"{psnr:.2f} dB (limit >= 60)")
    if not psnr >= 60.0:
        fail(f"DEPLOY with and without dcn_fused agree to {psnr:.2f} dB < 60 dB")
    _gate_vs_plain(lr[:GATE_PLAIN_FRAMES], hr[:GATE_PLAIN_FRAMES], gaze[:GATE_PLAIN_FRAMES])
    return launches


def _gate_vs_plain(lr, hr, gaze):
    """The gate's paths through the kernels against the same paths through
    the plain versions, over the first frames of one clip: the streamed
    frames of each configuration, and the zone evaluation of the kernels'
    frames with kernel F against the same evaluation with F's plain
    version. The f32 configurations (DEPLOY's weights upcast from bf16)
    hold what phase 3 holds; bf16 DEPLOY, where a one-ulp difference of a
    rounded activation is 2^-8 of it and recurs, holds a looser bound."""
    import torch

    from crfp_torch.bench import deploy_gate as dg
    from crfp_torch.eval.zones import OnChipZoneEval

    for tag, kw, f32, db_min, d_max in (
        ("EXACT f32", dict(deploy=False), False, 80.0, 1e-3),
        ("DEPLOY f32 dcn_fused", dict(deploy=True, dcn_fused=True), True, 80.0, 1e-3),
        ("DEPLOY f32 structured", dict(deploy=True, dcn_fused=False), True, 80.0, 1e-3),
        ("DEPLOY bf16 dcn_fused", dict(deploy=True, dcn_fused=True), False,
         GATE_PLAIN_BF16_DB, None),
    ):
        runner = dg.build_runner(str(GATE_CKPT), MID, device="cuda", **kw)
        if f32:
            runner.model.float()
        ev_kernel = OnChipZoneEval(dg.FV_SIZE, "cuda")
        ev_plain = OnChipZoneEval(dg.FV_SIZE, "cuda")
        got = list(dg.stream_clip(runner, lr, hr, gaze))
        for z, out, gt in got:
            ev_kernel.update(out, gt, z)
        with plain_kernels():
            want = [out for _, out, _ in dg.stream_clip(runner, lr, hr, gaze)]
            for z, out, gt in got:
                ev_plain.update(out, gt, z)
        _frames_agree(f"[gate] {tag}", [g for _, g, _ in got], want, db_min, d_max)
        worst = {"psnr": 0.0, "ssim": 0.0}
        for key, vals in ev_kernel.results.items():
            other = ev_plain.results[key]
            if len(vals) != len(other):
                fail(f"gate {tag}: zone evaluators recorded {len(vals)} and {len(other)} {key}")
            m = key.split("_")[0]
            worst[m] = max([worst[m]] + [abs(a - b) for a, b in zip(vals, other)])
        print(f"[gate] {tag}: zone evaluation of {len(got)} frames, kernel F vs its plain "
              f"version: max |dPSNR| {worst['psnr']:.3e} dB (limit 1e-4), max |dSSIM| "
              f"{worst['ssim']:.3e} (limit 1e-5)")
        if not (worst["psnr"] <= 1e-4 and worst["ssim"] <= 1e-5):
            fail(f"gate {tag}: zone evaluation with kernel F and with its plain version "
                 f"differ by {worst}")


def _grads(fn, inputs, grad_out):
    """(output, gradients of every input) of ``fn`` for ``grad_out``."""
    import torch

    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, grad_out)
    return out.detach(), grads


def _time_backward(fn, inputs, grad_out, iters=20):
    """(call ms, device ms) of autograd's backward through ``fn`` alone (the
    forward graph is built once and kept). Forward and backward run on one
    side stream, which is also the one the device time is captured on."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)

        def run():
            return torch.autograd.grad(out, leaves, grad_out, retain_graph=True)

        call_ms = time_ms(run, iters=iters)
    torch.cuda.current_stream().wait_stream(side)
    return call_ms, device_time_ms(run, launches=iters, stream=side)


def phase_kernels_train(gen):
    """Phase 5: kernels D and F at the training shapes. Returns their
    records (calls per train step)."""
    import torch

    from crfp_torch.bench.train import RECIPE
    from crfp_torch.ops.cuda import dcn, ssim, warp
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    b, t, gt, mid = RECIPE["b"], RECIPE["t"], RECIPE["gt"], RECIPE["mid"]
    n_rec = t - 1  # recurrent steps per clip
    lv = (gt // 4, gt // 4)
    modes = []
    record = functools.partial(_record, modes)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    def check_grads(kernel, mode, got, want, tol):
        """max|d| <= tol * max|ref| for every gradient; returns (max abs
        error, max relative error)."""
        abs_err, rel_err = 0.0, 0.0
        for i, (g_, w_) in enumerate(zip(got, want)):
            d = float((g_.float() - w_).abs().max())
            rel = d / float(w_.abs().max())
            if not rel <= tol:
                fail(f"{kernel} {mode}: gradient {i} max|d| {d} is {rel:.3e} of "
                     f"max|ref| > {tol}")
            abs_err, rel_err = max(abs_err, d), max(rel_err, rel)
        return abs_err, rel_err

    # ---- D for the DCN stages: per-tap dcn_0/1/2, shared-tap dcn_3, at the
    # recipe's mid 32 and at the mid-16 widths; then unclamped (pad 0) at the
    # shapes of train.sh (B 8, GT 256), from a generator of their own so that
    # the modes after them get the operands they got --------------------------
    gb_, mb_ = MAIN_B, MAIN_GT // 4
    own_u = torch.Generator().manual_seed(10)
    for mode, (b_, c, o, g, hw, d, amp, shared, calls, gen_) in {
        f"per-tap G=8 D=8 ({b},{mid},{lv[0]},{lv[1]})": (
            b, mid, mid, 8, lv, 8, 8, False, 3 * n_rec, gen),
        f"shared G=1 D=32 ({b},{mid // 8},{gt},{gt})": (
            b, mid // 8, mid // 8, 1, (gt, gt), 32, 32, True, n_rec, gen),
        f"per-tap G=8 D=8 ({b},16,{lv[0]},{lv[1]}) mid16": (
            b, 16, 16, 8, lv, 8, 8, False, 0, gen),
        f"shared G=1 D=32 ({b},2,{gt},{gt}) mid16": (
            b, 2, 2, 1, (gt, gt), 32, 32, True, 0, gen),
        f"per-tap G=8 unclamped ({gb_},{mid},{mb_},{mb_}) train.sh": (
            gb_, mid, mid, 8, (mb_, mb_), None, 8, False, 0, own_u),
        f"shared G=1 unclamped ({gb_},{mid // 8},{MAIN_GT},{MAIN_GT}) train.sh": (
            gb_, mid // 8, mid // 8, 1, (MAIN_GT, MAIN_GT), None, 32, True, 0, own_u),
    }.items():
        taps = 1 if shared else 9

        def rn(*shape, std=1.0, gen_=gen_):
            return (torch.randn(*shape, generator=gen_) * std).cuda()

        x = rn(b_, c, *hw)
        noisy = rn(b_, g * taps * 2, *hw, std=0.75 * amp)
        off = (_smooth(gen_, 2, hw, amp, n=b_).repeat(1, g * taps, 1, 1)
               + rn(b_, g * taps * 2, *hw, std=1.0 if shared else 2.0))
        mask = torch.rand(b_, g * taps, *hw, generator=gen_).cuda()
        wt = rn(o, c, 3, 3, std=0.1)
        bias = rn(o)
        gout = rn(b_, o, *hw)
        kw = dict(max_displacement=d, shared_taps=shared, shared_mask=shared)

        def kern(*a):
            return dcn.deform_conv2d_windowed(*a, **kw)

        def plain(*a):
            return deform_conv2d_windowed_ref(*a, **kw)

        err = 0.0
        for o_ in (noisy, off):
            _, got = _grads(kern, (x, o_, mask, wt, bias), gout)
            _, want = _grads(plain, (x, o_, mask, wt, bias), gout)
            torch.cuda.synchronize()
            err = max(err, check_grads("kernel D dcn", mode, got, want, 1e-4)[0])
        xb, gb = x.to(torch.bfloat16), gout.to(torch.bfloat16)
        _, gotb = _grads(kern, (xb, off, mask, wt, bias), gb)
        torch.cuda.synchronize()
        _, rel = check_grads("kernel D dcn bf16", mode, gotb, want, 2e-2)
        # d-offset, d-mask and dW are summed in a fixed order (dx alone by
        # atomics): two runs and a replay from a CUDA graph give the same bits
        for o_, x_, g_ in ((noisy, x, gout), (off, xb, gb)):
            def fixed(o_=o_, x_=x_, g_=g_):
                return torch.cat([t.flatten() for t in
                                  dcn.dcn_backward(x_, o_, mask, wt, g_, **kw)[1:]])
            first, again, replay = fixed(), fixed(), captured(fixed)
            if not (torch.equal(first, again) and torch.equal(first, replay)):
                fail(f"kernel D dcn {mode}: d-offset, d-mask and dW of two runs on the same "
                     "inputs (eager, eager, CUDA graph) are not bit-equal")
        k_ms = measure(lambda: dcn.dcn_backward(xb, off, mask, wt, gb, **kw))
        p_ms = _time_backward(plain, (xb, off, mask, wt, bias), gb, iters=5)
        n_px = b_ * hw[0] * hw[1]
        # per (pixel, group, tap, channel): the O-wide contraction for s and
        # for dW, the four-corner sample and its two position derivatives
        flops = n_px * g * 9 * (c // g) * (4 * o + 22)
        dxb, doff, dmask, dw = dcn.dcn_backward(xb, off, mask, wt, gb, **kw)
        plan = dcn.bwd_plan(b_, c, *hw, o, g, d, shared_taps=shared)
        bnd = bound([xb, off, mask, wt, gb], [dxb, doff, dmask, dw], flops, "bfloat16")
        record("dcn_bwd", mode, calls, err, rel, k_ms, p_ms, None, bnd,
               bound_fraction=bnd[0] / k_ms[1], tile=f"{plan.tile_h}x{plan.tile_w} pad "
               f"{plan.pad} grid {plan.grid}{' patch' if plan.patch else ''}",
               # d-offset, d-mask and dW: dx alone is summed by atomics, in
               # an order that changes from run to run
               digest=digest(got[1], got[2], got[3], doff, dmask, dw))

    # ---- D at k=1: the HR state, lv3_state and the stacked lv states; with
    # no clamp basic_fvsr's four stacked states (flow drawn at +-8, from a
    # generator of its own, so that F's modes get the operands they got) ---
    own_d = torch.Generator().manual_seed(9)
    for mode, (c, hw, d, calls) in {
        f"HR D=32 ({b},{mid // 8},{gt},{gt})": (mid // 8, (gt, gt), 32, n_rec),
        f"lv3_state D=8 ({b},{mid},{lv[0]},{lv[1]})": (mid, lv, 8, n_rec),
        f"lv D=8 ({b},{3 * mid // 4},{lv[0]},{lv[1]})": (3 * mid // 4, lv, 8, n_rec),
        f"stack unclamped ({b},{4 * mid},{lv[0]},{lv[1]}) basic_fvsr": (4 * mid, lv, None, 0),
    }.items():
        amp, g_ = (8, own_d) if d is None else (d, gen)
        x = (torch.randn(b, c, *hw, generator=g_)).cuda()
        noisy = (torch.randn(b, 2, *hw, generator=g_) * (0.75 * amp)).cuda()
        flow = _smooth(g_, 2, hw, amp, n=b)
        gout = (torch.randn(b, c, *hw, generator=g_)).cuda()

        def kern(x_, f_):
            return warp.flow_warp_windowed(x_, f_, d)

        def plain(x_, f_):
            return flow_warp_windowed_ref(x_, f_, d)

        err = 0.0
        for f_ in (noisy, flow):
            _, got = _grads(kern, (x, f_), gout)
            _, want = _grads(plain, (x, f_), gout)
            torch.cuda.synchronize()
            err = max(err, check_grads("kernel D warp", mode, got, want, 1e-4)[0])
        xb, gb = x.to(torch.bfloat16), gout.to(torch.bfloat16)
        _, gotb = _grads(kern, (xb, flow), gb)
        torch.cuda.synchronize()
        _, rel = check_grads("kernel D warp bf16", mode, gotb, want, 2e-2)
        k_ms = measure(lambda: warp.flow_warp_backward(xb, flow, gb, d))
        p_ms = _time_backward(plain, (xb, flow), gb, iters=5)
        # yardstick: grid_sample's backward on a precomputed bf16 grid (the
        # clamp is outside it, as in phase 2's forward yardstick)
        h, w = hw
        fc = flow if d is None else flow.clamp(-d, d)
        gx = (torch.arange(w, device="cuda").view(1, 1, w) + fc[:, 0]) * (2.0 / (w - 1)) - 1
        gy = (torch.arange(h, device="cuda").view(1, h, 1) + fc[:, 1]) * (2.0 / (h - 1)) - 1
        grid = torch.stack([gx, gy], dim=-1).to(torch.bfloat16)
        lib_ms = measure(lambda: torch.ops.aten.grid_sampler_2d_backward(
            gb, xb, grid, 0, 0, True, [True, True]))
        dxb, dflow = warp.flow_warp_backward(xb, flow, gb, d)
        # d-flow is reduced in a fixed order (no atomics): two runs on the
        # same inputs, and a replay from a CUDA graph, give the same bits
        for f_, x_, g_ in ((noisy, x, gout), (flow, xb, gb)):
            first = warp.flow_warp_backward(x_, f_, g_, d)[1]
            again = warp.flow_warp_backward(x_, f_, g_, d)[1]
            replay = captured(lambda: warp.flow_warp_backward(x_, f_, g_, d)[1])
            if not (torch.equal(first, again) and torch.equal(first, replay)):
                fail(f"kernel D warp {mode}: d-flow of two runs on the same inputs "
                     "(eager, eager, CUDA graph) is not bit-equal")
        record("flow_warp_bwd", mode, calls, err, rel, k_ms, p_ms, lib_ms,
               bound([xb, flow, gb], [dxb, dflow], 20 * b * h * w * c, "bfloat16"),
               digest=digest(got[1], dflow))

    # ---- F: the train step's RGB and luma calls, a 1080p frame, the gate's
    # evaluated frame and three ragged shapes; NCHW-contiguous operands, NCHW
    # views of NHWC memory (as the zone evaluator passes them) and the train
    # step's layouts (its output an NHWC view of NCHW memory, its ground
    # truth NHWC), which must all give the same bits -------------------------
    from crfp_torch.ops.metrics import masked_ssim

    for mode, (n, c, h, w, calls) in {
        f"RGB ({b * t},{gt},{gt},3)": (b * t, 3, gt, gt, 1),
        f"Y ({b * t},{gt},{gt},1)": (b * t, 1, gt, gt, 1),
        "1080p (1,1080,1920,3) (checked, not on the path)": (1, 3, 1080, 1920, 0),
        f"gate (1,{GATE_LR_HW[0] * 8},{GATE_LR_HW[1] * 8},3)": (
            1, 3, GATE_LR_HW[0] * 8, GATE_LR_HW[1] * 8, 0),
        "ragged (1,5,7,1)": (1, 1, 5, 7, 0),
        "ragged (2,33,65,1)": (2, 1, 33, 65, 0),
        "ragged (1,11,11,3)": (1, 3, 11, 11, 0),
    }.items():
        # white-noise frames: the map's f32 rounding (<x^2> - mu^2 over
        # C2 = 9e-4) stays far below the limit in both versions
        hr = torch.rand(n, c, h, w, generator=gen).cuda()
        sr = (hr + randn(n, c, h, w, std=0.1)).clamp(0, 1)
        got = ssim.ssim_map(sr, hr)
        want = ssim.ssim_map_ref(sr, hr)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        mean_err = float((got.double().mean() - want.double().mean()).abs())
        if not (err <= 1e-5 and mean_err <= 1e-6):
            fail(f"kernel F ssim {mode}: map max|d| {err} (limit 1e-5), masked mean "
                 f"|d| {mean_err} (limit 1e-6)")
        sr_h, hr_h = (a.permute(0, 2, 3, 1).contiguous() for a in (sr, hr))
        x_h, y_h = sr_h.permute(0, 3, 1, 2), hr_h.permute(0, 3, 1, 2)
        if not (torch.equal(ssim.ssim_map(x_h, y_h), got)
                and torch.equal(ssim.ssim_map(sr, y_h), got)
                and torch.equal(ssim.ssim_map(sr, hr), got)
                and torch.equal(captured(lambda: ssim.ssim_map(sr, hr)), got)):
            fail(f"kernel F ssim {mode}: NHWC views, the step's layouts, a second run "
                 "and a CUDA-graph replay are not all bit-equal to the first run")
        k_ms = measure(lambda: ssim.ssim_map(sr, hr))
        h_ms = measure(lambda: ssim.ssim_map(x_h, y_h))
        # the plain version builds its window from host values: no capture
        p_ms = measure(lambda: ssim.ssim_map_ref(sr, hr), iters=5, capturable=False)
        extra = {}
        if calls:
            # the kernel and the whole masked mean on the train step's layouts
            s_ms = measure(lambda: ssim.ssim_map(sr, y_h))
            extra["step_device_ms"], extra["step_call_ms"] = s_ms[1], s_ms[0]
            sr_step, ones = sr.permute(0, 2, 3, 1), torch.ones_like(hr_h[..., :1])
            call_ms, dev_ms = measure(lambda: masked_ssim(sr_step, hr_h, ones))
            extra["masked_ssim_device_ms"], extra["masked_ssim_call_ms"] = dev_ms, call_ms
        # two 11-tap passes over five moments, the three products x^2, y^2,
        # xy once per pixel, the formula
        flops = n * c * h * w * (2 * 5 * 11 * 2 + 3 + 15)
        bnd = bound([sr, hr], [got], flops, "float32")
        plan = ssim.ssim_plan(n, c, h, w)
        record("ssim", mode, calls, err, None, k_ms, p_ms, None, bnd,
               bound_fraction=bnd[0] / k_ms[1], tile=f"{ssim.TILE_W}x{ssim.TILE_H} strip "
               f"{ssim.STRIP}, {plan.threads} threads, grid {plan.grid}",
               nhwc_device_ms=h_ms[1], nhwc_call_ms=h_ms[0], **extra, digest=digest(got))
    return modes


@functools.cache
def _train_batches():
    """The 3 recipe batches of phases 3c and 6 (seed 0), made once."""
    from crfp_torch.bench.train import device_batches

    return device_batches(3, seed=0)


def _train_vs_plain(tag, steps, lr, expect, batches, **build_kw):
    """``steps`` f32 train steps of ``build_trainer(**build_kw)`` through the
    kernels against the same steps through the plain versions, from the
    same state and batches: losses to 1e-4 relative, every parameter to
    2*lr*steps, the kernel path's launch counts equal to ``expect``.
    Returns those counts."""
    from crfp_torch.bench.train import build_trainer

    def run(path):
        model, opt, step = build_trainer(amp=False, lr_rate=lr, **build_kw)
        t0 = time.perf_counter()
        losses = []
        for i in range(steps):
            m = step(opt, batches[i], i)
            losses.append(float(m["loss"]))
            print(f"{tag} {path} f32 step {i}: " + ", ".join(
                f"{k} {float(v):.6f}" for k, v in m.items()))
        print(f"{tag} {path}: {steps} f32 steps in {time.perf_counter() - t0:.2f} s "
              "(host clock, first steps)")
        return losses, {n: p.detach().clone() for n, p in model.named_parameters()}

    with plain_kernels():
        want_losses, want_params = run("plain")
    _zero_counts()
    got_losses, got_params = run("kernels")
    launches = _counts()
    print(f"{tag} launches in {steps} kernel steps: {launches}")
    if launches != expect:
        fail(f"{tag}: launch counts {launches} != expected {expect}")
    for i, (g, w) in enumerate(zip(got_losses, want_losses)):
        if not (math.isfinite(g) and abs(g - w) <= 1e-4 * abs(w)):
            fail(f"{tag} train step {i}: loss {g} through the kernels, {w} plain")
    worst = max(float((got_params[k] - want_params[k]).abs().max()) for k in want_params)
    print(f"{tag} losses kernels {got_losses} plain {want_losses}; max param "
          f"|d| after {steps} steps {worst:.3e} (limit {2 * lr * steps:.1e})")
    if not worst <= 2 * lr * steps:
        fail(f"{tag} parameters differ by {worst} > {2 * lr * steps} after {steps} steps")
    return launches


def phase_train():
    """Phase 6."""
    from crfp_torch.bench.train import build_trainer

    steps, lr = 3, 2e-4
    batches = _train_batches()
    _train_vs_plain("[train]", steps, lr, _train_expect(steps), batches, ckpt=str(CKPT))

    # amp: 10 steps on one batch from the checkpoint must stay finite; 10
    # from the seeded init must descend. (From the trained weights, Adam's
    # first step moves every parameter by the full rate whatever its
    # gradient, and that step raises the loss on a batch the model already
    # fits; 10 steps do not win it back.)
    for tag, ckpt in (("checkpoint", str(CKPT)), ("seeded init", None)):
        _, opt, step = build_trainer(amp=True, ckpt=ckpt, lr_rate=lr)
        amp_losses = [float(step(opt, batches[0], i)["loss"]) for i in range(10)]
        print(f"[train] amp losses on one batch from the {tag}: {amp_losses}")
        if not all(math.isfinite(v) for v in amp_losses):
            fail(f"amp steps from the {tag} gave non-finite losses: {amp_losses}")
    if not amp_losses[-1] < amp_losses[0]:
        fail(f"amp steps from the seeded init did not descend: {amp_losses}")


def phase_train_bench():
    """Phase 7: the training main path, amp at the recipe. Returns the
    launch counts of the bench's steps (warm-up and timed)."""
    from crfp_torch.bench.train import run_train_bench

    steps, warmup = 10, 3
    _zero_counts()
    res = run_train_bench(steps=steps, warmup=warmup)
    launches = _counts()
    print(f"[train bench] {json.dumps(res)}")
    expect = _train_expect(warmup + steps)
    print(f"[train bench] launches in {warmup + steps} amp steps: {launches}")
    if launches != expect:
        fail(f"amp train launch counts {launches} != expected {expect}")
    return launches


# Phase 9: the reference's own entry point, python -m crfp_torch.main, over a
# REDS-shaped tree on disk at the train.sh recipe (v18, mid 32, scale 8, batch
# 8, FV 128, GT 256, N_frames 15, f32, unclamped DCN: no --dcn_window flags).
MAIN_GT_HW, MAIN_T = (720, 1280), 15
# two training clips of 26 frames: 12 windows of 15 each, 3 steps at batch 8
MAIN_TRAIN_CLIPS, MAIN_TRAIN_FRAMES = ("100", "101"), 26
MAIN_HELDOUT = (("train", ("000", "011", "015", "020")),
                ("val", ("000", "001", "006", "017")))
TRAIN_SH = ["--reset", "true", "--log_file_name", "train.log", "--num_gpu", "4",
            "--num_workers", "9", "--dataset", "Reds", "--variant", "v18",
            "--mid_channels", "32", "--lr_rate", "2e-4", "--lr_rate_flow", "2.5e-5",
            "--rec_w", "1", "--scale", "8", "--batch_size", "8", "--FV_size", "128",
            "--GT_size", "256", "--N_frames", "15", "--y_only", "false",
            "--num_epochs", "1", "--print_every", "200", "--save_every", "3",
            "--val_every", "1", "--viz_every", "3"]
EVAL_SH = ["--reset", "true", "--dataset", "Reds", "--variant", "v18",
           "--mid_channels", "32", "--scale", "8", "--FV_size", "128", "--GT_size", "256",
           "--N_frames", "15"]


def _write_reds_tree(root: Path, seed: int = 0) -> Path:
    """A REDS-shaped tree of smooth moving content: GT 720x1280 under
    ``REDS_sharp``, LR 90x160 (the GT's 8x8 box means) under
    ``REDS_sharp_BI_x8``. One held-out clip of MAIN_T frames, symlinked under
    the four train and four val held-out names; MAIN_TRAIN_CLIPS training
    clips of MAIN_TRAIN_FRAMES frames. Returns the ``--dataset_dir``."""
    import numpy as np
    import PIL.Image
    import torch
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(seed)
    h, w = MAIN_GT_HW

    def clip(n):
        v = (torch.randint(-8, 9, (2,), generator=gen)).tolist()  # HR px a frame
        pad = 8 * n + 8
        ch, cw = h + 2 * pad, w + 2 * pad
        canvas = sum(a * F.interpolate(torch.rand(1, 3, ch // s + 2, cw // s + 2,
                                                  generator=gen), size=(ch, cw),
                                       mode="bicubic", align_corners=False)
                     for s, a in ((64, 0.6), (16, 0.3), (4, 0.1)))
        canvas = (canvas[0].clamp(0, 1) * 255).round().to(torch.uint8).permute(1, 2, 0)
        canvas = canvas.numpy()
        for k in range(n):
            y0, x0 = pad + k * v[0], pad + k * v[1]
            gt = canvas[y0:y0 + h, x0:x0 + w]
            lr = gt.reshape(h // 8, 8, w // 8, 8, 3).mean((1, 3)).round().astype(np.uint8)
            yield k, np.ascontiguousarray(gt), lr

    def write(name, split, n):
        dirs = []
        for tree in ("REDS_sharp", "REDS_sharp_BI_x8"):
            d = root / tree / split / split / f"{split}_sharp" / name
            d.mkdir(parents=True)
            dirs.append(d)
        for k, gt, lr in clip(n):
            PIL.Image.fromarray(gt).save(dirs[0] / f"{k:08d}.png", compress_level=1)
            PIL.Image.fromarray(lr).save(dirs[1] / f"{k:08d}.png", compress_level=1)
        return dirs

    held = write("000", "train", MAIN_T)
    for split, names in MAIN_HELDOUT:
        for name in names:
            if (split, name) == ("train", "000"):
                continue
            for tree, src in zip(("REDS_sharp", "REDS_sharp_BI_x8"), held):
                link = root / tree / split / split / f"{split}_sharp" / name
                link.parent.mkdir(parents=True, exist_ok=True)
                link.symlink_to(src)
    for name in MAIN_TRAIN_CLIPS:
        write(name, "train", MAIN_TRAIN_FRAMES)
    return root / "REDS_sharp"


def _main_expect(train_steps=0, windows=0, viz=0) -> dict:
    """Kernel launches of the v18 batch trunk at N_frames MAIN_T: each
    recurrent step runs 4 DCNs (A) and 3 warps (B); a train step runs them
    twice (remat recomputes in the backward) plus kernel D once each and two
    SSIMs (F); an evaluated window (a forward without gradients) runs them
    once and two SSIMs a frame; a dashboard dump one forward without F."""
    n = MAIN_T - 1
    fwd = 2 * train_steps + windows + viz
    return _expect(dcn_fwd=4 * n * fwd, flow_warp=3 * n * fwd,
                   dcn_bwd=4 * n * train_steps, flow_warp_bwd=3 * n * train_steps,
                   ssim=2 * train_steps + 2 * MAIN_T * windows)


def phase_main(tmp: Path):
    """Phase 9, on a tree it writes under ``tmp``. Returns the launch counts
    of the train run."""
    import torch

    from crfp_torch import main as cli
    from crfp_torch.config import model_config, parse_args, train_config
    from crfp_torch.data.loader import get_dataloader
    from crfp_torch.data.reds import preprocess_path
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.tools import test_video
    from crfp_torch.train.checkpoint import CheckpointManager
    from crfp_torch.train.loop import make_optimizer, make_train_step
    from crfp_torch.utils.params_io import load_params

    t_lap = time.perf_counter()

    def lap(what):
        nonlocal t_lap
        now = time.perf_counter()
        print(f"[time] phase 9 {what}: {now - t_lap:.1f} s")
        t_lap = now

    data = str(_write_reds_tree(tmp)) + "/"
    lap("REDS-shaped tree written")
    run = str(tmp / "train")
    argv = TRAIN_SH + ["--save_dir", run, "--dataset_dir", data,
                       "--frame_cache", str(tmp / "cache")]
    windows = len(MAIN_TRAIN_CLIPS) * (MAIN_TRAIN_FRAMES - MAIN_T + 1)
    steps = windows // MAIN_B
    n_eval = len(MAIN_HELDOUT[1][1])

    # ---- train through the entry point, train.sh's flags -----------------
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [m["loss"] for m in out["metrics"]]
    print(f"[main] train {steps} steps (B {MAIN_B}, T {MAIN_T}, GT 256, mid 32, f32, "
          f"unclamped) + dashboard + val over {n_eval} windows at 720p: {wall:.2f} s "
          f"(host clock, loader and kernel builds warm); losses {losses}; peak "
          f"{peak:.1f} MiB; launches {launches}; host preprocess {preprocess_path()}")
    expect = _main_expect(train_steps=steps, windows=n_eval, viz=1)
    if launches != expect:
        fail(f"main train launch counts {launches} != expected {expect}")
    if out["step"] != steps or not all(math.isfinite(v) for v in losses):
        fail(f"main train: {out['step']} steps (expected {steps}), losses {losses}")
    for rel in ("model/3/state.pt", "metrics.jsonl", "dashboard.html", "train.log",
                "viz/latest_sr.png", "viz/latest_ssim_map_discrete.png",
                "viz/sr_iter0000003.png"):
        if not (Path(run) / rel).is_file():
            fail(f"main train wrote no {rel}")
    _expect_world_1(Path(run) / "train.log", "main train")
    lap("train")

    # ---- restore: the saved model, both Adam groups and the step --------
    args = parse_args(argv)
    model = CRFP(model_config(args), device="cuda", seed=1)
    opt = make_optimizer(model, train_config(args))
    step = CheckpointManager(str(Path(run) / "model")).restore(model, opt)
    a, b = opt.state_dict(), out["optimizer"].state_dict()
    same = (step == steps and a["param_groups"] == b["param_groups"]
            and all(torch.equal(v, out["model"].state_dict()[k])
                    for k, v in model.state_dict().items())
            and a["state"].keys() == b["state"].keys()
            and all(torch.equal(v, b["state"][i][k]) for i in a["state"]
                    for k, v in a["state"][i].items()))
    groups = [len(g["params"]) for g in a["param_groups"]]
    print(f"[main] restore of step {step}: model, Adam groups {groups} "
          f"({len(a['state'])} parameters with state) bit-equal: {same}")
    if not same:
        fail("main: CheckpointManager.restore did not give back the saved state")

    # ---- the loader alone, and the train step at the full recipe ---------
    loader = get_dataloader(args)["train"]
    t0 = time.perf_counter()
    batches = list(loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    first = batches[0]
    batch = {"lr": first["LR"], "fv": first["HR"], "hr": first["HR"],
             "mk": first["Ref_sp"]}
    train_step = make_train_step(model, train_config(args))
    dev = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    for i in range(2):
        train_step(opt, dev, steps + i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_timed = 3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_timed):
        train_step(opt, dev, steps + 2 + i)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n_timed
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"[main] loader alone (9 threads, frame cache warm): {loader_ms:.1f} ms a "
          f"batch of {MAIN_B} windows over {len(batches)} batches (host clock); train "
          f"step at the full recipe (f32, unclamped, batch on the card): "
          f"{step_ms:.1f} ms (CUDA events, {n_timed} steps), peak {step_peak:.1f} MiB")
    lap("restore, loader and step timing")

    # ---- two unclamped f32 steps from one loader batch: kernels vs plain --
    def two_steps():
        m = CRFP(model_config(args), device="cuda", seed=0)
        m.load_state_dict(load_params(str(Path(run) / "model" / str(steps))))
        o = make_optimizer(m, train_config(args))
        st = make_train_step(m, train_config(args))
        ls = [float(st(o, batch, i)["loss"]) for i in range(2)]
        return ls, {n: p.detach().clone() for n, p in m.named_parameters()}

    with plain_kernels():
        want_l, want_p = two_steps()
    _zero_counts()
    got_l, got_p = two_steps()
    launches2 = _counts()
    lr = train_config(args).lr_rate
    worst = max(float((got_p[k] - want_p[k]).abs().max()) for k in want_p)
    print(f"[main] unclamped f32 steps from one loader batch: losses kernels {got_l} "
          f"plain {want_l}; max param |d| {worst:.3e} (limit {2 * lr * 2:.1e}); "
          f"launches {launches2}")
    if launches2 != _main_expect(train_steps=2):
        fail(f"main unclamped steps: launch counts {launches2} != "
             f"{_main_expect(train_steps=2)}")
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        if not (math.isfinite(g) and abs(g - w) <= 1e-4 * abs(w)):
            fail(f"main unclamped step {i}: loss {g} through the kernels, {w} plain")
    if not worst <= 2 * lr * 2:
        fail(f"main unclamped steps: parameters differ by {worst} > {2 * lr * 2}")
    lap("unclamped steps against plain versions")

    # ---- eval.sh and test.sh: the model directory, kernels vs plain -------
    ev = EVAL_SH + ["--dataset_dir", data, "--model_path", str(Path(run) / "model")]
    results = {}
    for tag, path in (("kernels", None), ("plain", plain_kernels)):
        with (path() if path else contextlib.nullcontext()):
            _zero_counts()
            results[tag] = cli.main(ev + ["--save_dir", str(tmp / f"eval_{tag}"),
                                          "--log_file_name", "eval.log", "--eval",
                                          "true"])
            if tag == "kernels":
                launches3 = _counts()
    log = (tmp / "eval_kernels" / "eval.log").read_text()
    line = next((ln for ln in log.splitlines() if "Ref  PSNR (max)" in ln), None)
    print(f"[main] eval over {Path(run, 'model')}: {line}; plain versions "
          f"{results['plain']}; launches {launches3}")
    if line is None:
        fail("main eval: no 'Ref  PSNR (max)' line in eval.log")
    if launches3 != _main_expect(windows=n_eval):
        fail(f"main eval launch counts {launches3} != {_main_expect(windows=n_eval)}")
    for k, tol in (("psnr", 1e-3), ("psnr_y", 1e-3), ("ssim", 1e-5), ("ssim_y", 1e-5)):
        g, w = results["kernels"][k], results["plain"][k]
        if not (math.isfinite(g) and abs(g - w) <= tol):
            fail(f"main eval {k}: {g} through the kernels, {w} plain (limit {tol})")
    res = cli.main(ev + ["--save_dir", str(tmp / "test"), "--log_file_name", "test.log",
                         "--test", "true"])
    print(f"[main] test over the REDS4 names: {res}")
    if not (res.n_frames == n_eval * MAIN_T - 1 and math.isfinite(res.psnr)):
        fail(f"main test: {res}")
    lap("eval.sh and test.sh")

    # ms per 720p eval frame: one window of MAIN_T frames, CUDA events
    window = next(iter(get_dataloader(args)["eval"]))
    lr_, fv_, mk_ = (torch.from_numpy(window[k]).cuda() for k in ("LR", "Ref", "Ref_sp"))
    with torch.no_grad():
        model(lr_, fv_, mk_)
        start.record()
        model(lr_, fv_, mk_)
        end.record()
    torch.cuda.synchronize()
    eval_ms = start.elapsed_time(end) / MAIN_T
    print(f"[main] eval forward: {eval_ms:.2f} ms a 720p frame (one window of "
          f"{MAIN_T} frames, f32, unclamped, CUDA events)")

    # ---- the held-out clip on disk through tools/test_video.py -----------
    frames = {"kernels": [], "plain": []}
    tv = ["--dataset_dir", data, "--video_set", "train", "--video_num", "0",
          "--mid_channels", "32", "--model_path", str(Path(run) / "model" / str(steps)),
          "--n_frames", str(MAIN_T)]
    for tag, path in (("plain", plain_kernels), ("kernels", None)):
        with (path() if path else contextlib.nullcontext()):
            _zero_counts()
            summary = test_video.main(
                tv + ["--save_dir", str(tmp / f"video_{tag}")],
                on_frame=lambda v, i, sr, tag=tag: frames[tag].append(sr.clone()))
            launches4 = _counts()
    n = MAIN_T - 1
    # StreamingRunner: 4 DCNs and 3 warps a steady frame; the zone
    # evaluator's masked SSIM per zone (3 on the first frame, then 4)
    expect4 = _expect(dcn_fwd=4 * n, flow_warp=3 * n, ssim=3 + 4 * n)
    print(f"[main] test_video on the held-out clip: {summary}; launches {launches4}")
    if launches4 != expect4:
        fail(f"main test_video launch counts {launches4} != {expect4}")
    _frames_agree("[main] test_video", frames["kernels"], frames["plain"], d_max=None,
                  shape=(1, *MAIN_GT_HW, 3))
    lap("test_video")
    return launches


def _expect_world_1(log: Path, tag: str) -> None:
    """The log of a train run with --num_gpu 4 on this one-card machine names
    a world of 1, below the 4 asked for."""
    import torch

    n = torch.cuda.device_count()
    want = (f"data parallel: world {min(4, n)} (--num_gpu 4, {n} card(s))"
            + ("; below --num_gpu 4" if n < 4 else ""))
    line = next((ln for ln in log.read_text().splitlines() if "data parallel: world" in ln),
                "")
    print(f"{tag}: {line.split(' - INFO: ')[-1]}")
    if want not in line:
        fail(f"{tag}: the log does not say '{want}': {line!r}")


# Phase 10: the parallel paths on the one card. Two ranks share cuda:0 over gloo
# (NCCL refuses two ranks on one device; gloo takes CUDA tensors for the
# collectives the paths use); they measure the halo and collective overhead,
# not scaling. NCCL itself is held on a group of one rank.
PAR_WORLD, PAR_STEPS, PAR_TIMED_STEPS, PAR_FRAMES = 2, 2, 3, 3
PAR_LR = 2e-4
PAR_WINDOWS = (("windows 8/32", dict(dcn_window=8, dcn_window_hr=32)),
               ("unclamped", dict(dcn_window=None, dcn_window_hr=None)))
PAR_JOIN_S = 300


def _par_trainer(group=None):
    """The batch CRFP of phase 6 (checkpoint, strict, windows 8/32, remat) and
    its f32 step at PAR_LR, data-parallel over ``group``."""
    from crfp_torch.bench.train import build_trainer

    return build_trainer(amp=False, ckpt=str(CKPT), lr_rate=PAR_LR, group=group)


def _par_stream(runner, frames):
    """The frames of phase 3b's 720p clip through ``runner`` and the host ms
    of each (synchronised)."""
    import torch

    lr, hr, masks = _variant_clip(VARIANT_FRAMES)
    outs, ms = [], []
    for i in range(frames):
        t0 = time.perf_counter()
        outs.append(runner(lr[i][None], hr[i][None], masks[i][None]).float())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def _par_model(cfg):
    """v18 mid 32 from the checkpoint at the windows of ``cfg``, f32."""
    import torch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, load_npz

    model = CRFP(ModelConfig(mid_channels=MID, **cfg), device="cuda")
    model.load_state_dict(from_jax(load_npz(str(CKPT))), strict=True)
    return model.to(torch.float32).eval()


@contextlib.contextmanager
def _timed_collectives():
    """Count the sharded runner's halo exchanges and whole-frame gathers and
    their host ms (the card synchronised before and after each) while the
    block runs; yields the dict it fills."""
    import torch

    from crfp_torch.parallel import spatial

    out = {"halo_exchange": 0, "gather_rows": 0, "ms": 0.0}
    saved = {n: getattr(spatial, n) for n in ("halo_exchange", "gather_rows")}

    def timed_call(name):
        fn = saved[name]

        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            out["ms"] += (time.perf_counter() - t0) * 1e3
            out[name] += 1
            return r
        return call

    for n in saved:
        setattr(spatial, n, timed_call(n))
    try:
        yield out
    finally:
        for n, fn in saved.items():
            setattr(spatial, n, fn)


def _parallel_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One gloo rank on cuda:0: PAR_STEPS data-parallel f32 steps of the
    recipe (then PAR_TIMED_STEPS timed), and the height-sharded runner over
    PAR_FRAMES frames at each of PAR_WINDOWS, with the launch counts of
    each. Writes its results to ``out_dir/rank<rank>.pt``."""
    import hashlib

    import torch
    import torch.distributed as dist

    from crfp_torch.bench.train import device_batches
    from crfp_torch.parallel import (
        SpatialStreamingRunner,
        data_parallel_mesh,
        initialize_distributed,
        replicate,
        shard_batch,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(f"tcp://localhost:{port}", world, rank, backend="gloo",
                           device="cuda")
    res = {}
    try:
        mesh = data_parallel_mesh(world)
        model, opt, step = _par_trainer(mesh)
        replicate(model, mesh)
        batches = device_batches(PAR_STEPS + PAR_TIMED_STEPS, seed=0)
        _zero_counts()
        losses = [float(step(opt, shard_batch(batches[i], mesh), i)["loss"])
                  for i in range(PAR_STEPS)]
        res["train_launches"] = _counts()
        res["losses"] = losses
        res["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
        h = hashlib.sha256()
        for p in res["params"].values():
            h.update(p.numpy().tobytes())
        res["digest"] = h.hexdigest()[:16]
        dist.barrier()
        t0 = time.perf_counter()
        for i in range(PAR_STEPS, PAR_STEPS + PAR_TIMED_STEPS):
            step(opt, shard_batch(batches[i], mesh), i)
        torch.cuda.synchronize()
        dist.barrier()
        res["step_ms"] = (time.perf_counter() - t0) * 1e3 / PAR_TIMED_STEPS
        del model, opt, step
        for tag, cfg in PAR_WINDOWS:
            runner = SpatialStreamingRunner(_par_model(cfg), mesh)
            dist.barrier()
            # a warm pass that counts and times the collectives (synchronised
            # around each), then the checked and timed pass from a clear state
            with _timed_collectives() as coll:
                _par_stream(runner, PAR_FRAMES)
            res[f"{tag} collectives"] = coll
            runner.clear_states()
            dist.barrier()
            _zero_counts()
            outs, ms = _par_stream(runner, PAR_FRAMES)
            res[f"{tag} launches"] = _counts()
            res[f"{tag} ms"] = ms
            res[f"{tag} digest"] = digest(*outs)
            if rank == 0:
                res[f"{tag} frames"] = [o.cpu() for o in outs]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _nccl_rank(port: int, out_dir: str) -> None:
    """A one-rank NCCL group through initialize_distributed: an all-reduce of
    a CUDA tensor, a barrier, destroyed."""
    import torch
    import torch.distributed as dist

    from crfp_torch.parallel import initialize_distributed

    initialize_distributed(f"tcp://localhost:{port}", 1, 0, device="cuda")
    backend = dist.get_backend()
    t = torch.arange(4, dtype=torch.float32, device="cuda")
    dist.all_reduce(t)
    dist.barrier(device_ids=[torch.cuda.current_device()])
    dist.destroy_process_group()
    torch.save({"backend": backend, "sum": t.cpu(), "destroyed": not dist.is_initialized()},
               os.path.join(out_dir, "nccl.pt"))


def _spawn_ranks(target, args_of, n: int) -> None:
    """Start ``n`` processes of ``target(*args_of(rank))`` (spawn) and join
    each with a timeout; a rank that fails or hangs fails the phase."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_JOIN_S
    while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
           and all(p.exitcode in (None, 0) for p in procs)):
        time.sleep(0.05)
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
        codes.append(p.exitcode)
    if any(c != 0 for c in codes):
        fail(f"parallel: ranks of {target.__name__} exited with codes {codes} "
             f"(timeout {PAR_JOIN_S} s)")


def phase_parallel(tmp: Path) -> dict:
    """Phase 10, with phase 9's tree under ``tmp``. Returns rank 0's launch
    counts over its checked runs (the data-parallel steps and the sharded
    frames)."""
    import torch

    from crfp_torch.models.streaming import StreamingRunner
    from crfp_torch.parallel.sharding import free_port

    n_cards = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown card"

    # ---- NCCL: a group of one rank -----------------------------------------
    with tempfile.TemporaryDirectory(prefix="crfp_par_") as out:
        port = free_port()
        _spawn_ranks(_nccl_rank, lambda r: (port, out), 1)
        nccl = torch.load(os.path.join(out, "nccl.pt"))
    print(f"[parallel] NCCL one-rank group: backend {nccl['backend']}, all-reduce "
          f"{nccl['sum'].tolist()}, barrier passed, destroyed {nccl['destroyed']}")
    if not (nccl["backend"] == "nccl" and nccl["sum"].tolist() == [0.0, 1.0, 2.0, 3.0]
            and nccl["destroyed"]):
        fail(f"parallel: NCCL one-rank group {nccl}")

    # ---- the one-process references ------------------------------------------
    from crfp_torch.bench.train import device_batches

    batches = device_batches(PAR_STEPS + PAR_TIMED_STEPS, seed=0)
    model, opt, step = _par_trainer()
    want_losses = [float(step(opt, batches[i], i)["loss"]) for i in range(PAR_STEPS)]
    want_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(PAR_STEPS, PAR_STEPS + PAR_TIMED_STEPS):
        step(opt, batches[i], i)
    torch.cuda.synchronize()
    one_step_ms = (time.perf_counter() - t0) * 1e3 / PAR_TIMED_STEPS
    del model, opt, step
    want_frames, one_frame_ms = {}, {}
    for tag, cfg in PAR_WINDOWS:
        runner = StreamingRunner(_par_model(cfg))
        _par_stream(runner, PAR_FRAMES)  # warm
        runner.clear_states()
        want_frames[tag], one_frame_ms[tag] = _par_stream(runner, PAR_FRAMES)

    # ---- two ranks on cuda:0 over gloo -----------------------------------------
    with tempfile.TemporaryDirectory(prefix="crfp_par_") as out:
        port = free_port()
        _spawn_ranks(_parallel_rank, lambda r: (r, PAR_WORLD, port, out), PAR_WORLD)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(PAR_WORLD)]

    train_expect = _train_expect(PAR_STEPS)
    worst = max(float((ranks[0]["params"][k] - want_params[k].cpu()).abs().max())
                for k in want_params)
    print(f"[parallel] data parallel, {PAR_WORLD} ranks on one card (gloo), global B 2 "
          f"(1 a rank), T 7, GT 192, f32, windows 8/32, remat: losses {ranks[0]['losses']} "
          f"against one process {want_losses}; max param |d| after {PAR_STEPS} steps "
          f"{worst:.3e} (limit {2 * PAR_LR * PAR_STEPS:.1e}); digests "
          f"{[r['digest'] for r in ranks]}")
    for r, res in enumerate(ranks):
        print(f"[parallel] rank {r} launches in {PAR_STEPS} steps: {res['train_launches']}")
        if res["train_launches"] != train_expect:
            fail(f"parallel rank {r}: train launch counts {res['train_launches']} != "
                 f"{train_expect}")
        for i, (g, w) in enumerate(zip(res["losses"], want_losses)):
            if not (math.isfinite(g) and abs(g - w) <= 1e-4 * abs(w)):
                fail(f"parallel rank {r} step {i}: loss {g}, one process {w}")
    if len({r["digest"] for r in ranks}) != 1:
        fail(f"parallel: the ranks' parameters differ: {[r['digest'] for r in ranks]}")
    if not worst <= 2 * PAR_LR * PAR_STEPS:
        fail(f"parallel: parameters differ from one process by {worst}")

    steady = PAR_FRAMES - 1
    frame_expect = _expect(dcn_fwd=4 * steady, flow_warp=3 * steady)
    for tag, _ in PAR_WINDOWS:
        for r, res in enumerate(ranks):
            print(f"[parallel] spatial {tag}: rank {r} launches over {PAR_FRAMES} frames "
                  f"{res[f'{tag} launches']} (A {4} and B {3} a steady frame, one launch "
                  "a call on its slab)")
            if res[f"{tag} launches"] != frame_expect:
                fail(f"parallel spatial {tag} rank {r}: launches {res[f'{tag} launches']} "
                     f"!= {frame_expect}")
        if len({res[f"{tag} digest"] for res in ranks}) != 1:
            fail(f"parallel spatial {tag}: the ranks returned different frames")
        _frames_agree(f"[parallel] spatial {tag}", [f.cuda() for f in ranks[0][f"{tag} frames"]],
                      want_frames[tag], versus="2 ranks vs StreamingRunner",
                      shape=(1, GATE_LR_HW[0] * 8, GATE_LR_HW[1] * 8, 3))

    # ---- the entry point with --num_gpu 4 on this machine --------------------------
    run = tmp / "train_dp"
    argv = [a if a != "8" or TRAIN_SH[i - 1] != "--batch_size" else "24"
            for i, a in enumerate(TRAIN_SH)]
    argv += ["--save_dir", str(run), "--dataset_dir", str(tmp / "REDS_sharp") + "/",
             "--frame_cache", str(tmp / "cache"), "--val_every", "2", "--viz_every", "0",
             "--save_every", "999999"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "crfp_torch.main", "--cpu", "false", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=PAR_JOIN_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"parallel: python -m crfp_torch.main --num_gpu 4 exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    _expect_world_1(run / "train.log", "[parallel] python -m crfp_torch.main")
    if not (run / "model" / "1" / "state.pt").is_file():
        fail("parallel: python -m crfp_torch.main --num_gpu 4 took no step")
    print(f"[parallel] python -m crfp_torch.main --cpu false --num_gpu 4 (train.sh's flags, "
          f"one step of B 24 = the tree's 24 windows, no validation): {wall:.1f} s host clock")

    # ---- times: overhead of halos and collectives on one card, not scaling ------
    frame_ms = {tag: [sum(r[f"{tag} ms"][1:]) / steady for r in ranks] for tag, _ in PAR_WINDOWS}
    for tag, _ in PAR_WINDOWS:
        c = ranks[0][f"{tag} collectives"]
        print(f"[parallel] spatial {tag}, rank 0's warm pass of {PAR_FRAMES} frames: "
              f"{c['halo_exchange']} halo exchanges and {c['gather_rows']} whole-frame "
              f"gathers, {c['ms']:.1f} ms in them (host clock, synchronised)")
    print(f"[parallel] times on {card} ({n_cards} card(s)); two ranks sharing one card "
          "measure the halo and collective overhead, not scaling: ms a step (f32, host "
          f"clock, {PAR_TIMED_STEPS} steps) one process {one_step_ms:.1f}, two ranks "
          f"{[round(r['step_ms'], 1) for r in ranks]}; ms a steady 720p frame (f32, host "
          "clock) " + "; ".join(
              f"{tag}: one process {sum(one_frame_ms[tag][1:]) / steady:.1f}, two ranks "
              f"{[round(v, 1) for v in frame_ms[tag]]}" for tag, _ in PAR_WINDOWS))
    total = dict(ranks[0]["train_launches"])
    for tag, _ in PAR_WINDOWS:
        for k, v in ranks[0][f"{tag} launches"].items():
            total[k] += v
    return total


# phase 11: the capability checkpoints, the sigma whose first frames are held
# against the plain versions, and the TPU reading of the capability deltas
# (VERDICT.md:136-141, sigma-averaged PSNR dB; a quality reading, reported only)
TOOLS_PLAIN_SIGMA, TOOLS_PLAIN_FRAMES = 10.0, 6
# bf16 frames of a trained row, kernels against plain versions: the first
# readings on the H100 were 58.80-60.50 dB and max|d| <= 2.34e-2 (a bf16
# rounding or two of the output, carried by the recurrence), under phase
# 8's 60 dB; these limits keep a margin of about 2x on both
TOOLS_PLAIN_BF16_DB, TOOLS_PLAIN_BF16_DMAX = 55.0, 0.05
TPU_CAPABILITY_DB = {"v18_vs_bicubic_whole_db": 0.32, "v18_vs_no_dcn_whole_db": -0.52,
                     "v18_vs_basic_fvsr_whole_db": -0.28, "v18_vs_basic_fvsr_past_db": -0.27,
                     "v18_vs_bicubic_fovea_db": 10.5, "v18_vs_basic_fvsr_fovea_db": 3.8}


def _tools_capability() -> dict:
    """Phase 11's capability ablation at its defaults on the three trained
    mid-32 checkpoints, launch counts asserted; then sigma 10's first frames
    of each trained row through the kernels against the plain versions."""
    import numpy as np

    from crfp_torch.bench import capability as cap
    from crfp_torch.bench import card_line
    from crfp_torch.bench.deploy_gate import load_runner, stream_clip
    from crfp_torch.eval.zones import OnChipZoneEval

    ckpts = {r: str(ROOT / c) for r, c in cap.CKPTS.items()}
    sigmas, frames, hr_size = (10.0, 50.0, 100.0), 20, 768
    before = _counts()
    t0 = time.perf_counter()
    res = cap.run_capability(ckpts, sigmas=sigmas, hr_size=hr_size, frames=frames, mid=MID)
    wall = time.perf_counter() - t0
    launches = _since(before)
    print(f"[tools] capability ablation: hr {hr_size}, {frames} frames x sigmas {sigmas}, "
          f"mid {MID}, bf16, v18 windows 8/32 (plain clamp), held-out seeds from 9000: "
          f"{wall:.1f} s (host clock, models built and clips generated inside); "
          f"launches {launches}")
    # per steady frame: v18 A 4, B 3; basic_fvsr A 4, B 1; no_dcn B 1; one F
    # per frame for each of the four rows' evaluators
    steady = (frames - 1) * len(sigmas)
    expect = _expect(dcn_fwd=8 * steady, flow_warp=5 * steady, ssim=4 * frames * len(sigmas))
    if launches != expect:
        fail(f"capability launch counts {launches} != expected {expect}")
    print(f"[tools] {card_line()}")
    cap.print_tables(res)
    for row, per in res["rows"].items():
        for sigma, m in per.items():
            for k, v in m.items():
                if not (math.isfinite(v) and (k.startswith("psnr") or 0.0 <= v <= 1.0)):
                    fail(f"capability {row} sigma {sigma} {k} = {v}")
    print("[tools] capability deltas (PSNR dB, sigma-averaged) on the card beside the JAX "
          "package's TPU reading with anchored windows (VERDICT.md:136-141), a report:")
    for k, tpu in TPU_CAPABILITY_DB.items():
        print(f"[tools]   {k}: {res['deltas'][k]:+.4f} here, {tpu:+.2f} TPU")

    # sigma 10's first frames, each trained row through the kernels and the
    # plain versions: in f32 the frames at phase 8's f32 limits (the kernels'
    # arithmetic), in bf16 (the ablation's precision) at the bf16 limits above
    # and each zone's PSNR within 0.05 dB, the gate's budget
    si = sigmas.index(TOOLS_PLAIN_SIGMA)
    lr, hr, _, gaze = cap.sigma_clip(si, TOOLS_PLAIN_SIGMA, frames, hr_size)
    n = TOOLS_PLAIN_FRAMES
    for row in cap.ROWS:
        for bf16 in (False, True):
            tag = f"[tools] capability {row} {'bf16' if bf16 else 'f32'}"
            runner = load_runner(ckpts[row], cap.row_config(row, MID), bf16=bf16,
                                 device="cuda")
            ev_k, ev_p = (OnChipZoneEval(cap.FV_SIZE, "cuda") for _ in range(2))
            got = list(stream_clip(runner, lr[:n], hr[:n], gaze[:n]))
            for z, out, gt in got:
                ev_k.update(out, gt, z)
            with plain_kernels():
                want = list(stream_clip(runner, lr[:n], hr[:n], gaze[:n]))
                for z, out, gt in want:
                    ev_p.update(out, gt, z)
            _frames_agree(tag, [o for _, o, _ in got], [o for _, o, _ in want],
                          TOOLS_PLAIN_BF16_DB if bf16 else 80.0,
                          TOOLS_PLAIN_BF16_DMAX if bf16 else 1e-3,
                          shape=(1, hr_size, hr_size, 3))
            worst = max(abs(a - b) for k, v in ev_k.results.items() if k.startswith("psnr")
                        for a, b in zip(v, ev_p.results[k]))
            print(f"{tag}: {n} frames of sigma {TOOLS_PLAIN_SIGMA:g}, per-frame zone PSNR "
                  f"kernels vs plain: max |d| {worst:.4f} dB (limit 0.05)")
            if not worst <= 0.05:
                fail(f"{tag}: zone PSNR of kernels and plain versions differ by {worst} dB")
    return res


def _tools_quality() -> None:
    """Window quality under ground-truth flow (every pair inside the window
    must agree to >= 80 dB) and under the trained checkpoint's learned flow,
    each at its defaults, launch counts asserted."""
    from crfp_torch.bench.quality_trained import run_trained_quality
    from crfp_torch.bench.quality_window import run_window_quality

    before = _counts()
    t0 = time.perf_counter()
    rows = run_window_quality()
    launches = _since(before)
    print(f"[tools] window quality (ground-truth flow, lr 24x40, mid 32, 6 frames, seeded "
          f"f32): {time.perf_counter() - t0:.1f} s; launches {launches}")
    vels, wins = sorted({r.v_px for r in rows}), sorted({r.window for r in rows})
    # per velocity: the exact stream and one stream a window, 5 steady frames each
    expect = _expect(dcn_fwd=4 * 5 * (1 + len(wins)) * len(vels),
                     flow_warp=3 * 5 * (1 + len(wins)) * len(vels))
    if launches != expect:
        fail(f"window quality launch counts {launches} != expected {expect}")
    print("| v (LR px/f) | trunk px | " + " | ".join(f"D={d}" for d in wins) + " |")
    print("|---|---|" + "---|" * len(wins))
    agree = {(r.v_px, r.window): r.psnr_db for r in rows}
    for v in vels:
        print(f"| {v:g} | {2 * v:g} | " + " | ".join(f"{agree[(v, d)]:.2f}" for d in wins)
              + " |")
    for (v, d), db in agree.items():
        # inside the window: the trunk displacement 2v (and 8v at the HR
        # level against 4D) stays within D, so the clamp never bites
        if 2 * v <= d and not db >= 80.0:
            fail(f"window quality v {v} D {d}: inside the window yet {db} dB < 80")

    before = _counts()
    t0 = time.perf_counter()
    trained = run_trained_quality(str(GATE_CKPT), mid_channels=MID)
    launches = _since(before)
    print(f"[tools] trained quality ({GATE_CKPT.name}, learned flow, lr 24x40, 6 frames, "
          f"f32): {time.perf_counter() - t0:.1f} s; launches {launches}")
    expect = _expect(dcn_fwd=4 * 5 * 2 * len(trained), flow_warp=3 * 5 * 2 * len(trained))
    if launches != expect:
        fail(f"trained quality launch counts {launches} != expected {expect}")
    print("| v (LR px/f) | D | exact-vs-win dB | exact-vs-GT | win-vs-GT |")
    print("|---|---|---|---|---|")
    for r in trained:
        print(f"| {r.v_px} | {r.window} | {r.agree_db} | {r.exact_db} | {r.win_db} |")
        if not all(math.isfinite(x) for x in (r.agree_db, r.exact_db, r.win_db)):
            fail(f"trained quality row {r} is not finite")


def _reference_named(state: dict) -> dict:
    """``state`` (the port's v18 trunk) under the reference's own names, as
    its trainer saves them (``module.`` prefix, ``state_dict`` entry)."""
    from crfp_torch.params import to_reference

    return {"state_dict": {f"module.{k}": v for k, v in to_reference(state).items()}}


def _tools_convert(tmp: Path):
    """The trained v18 checkpoint written under the reference's names as a
    .pt, read back through load_params and streamed at the serving shape
    against the same weights from the .npz (bit-equal). Returns the two
    streams' frames and the flow of the first pair of frames."""
    import torch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.params import runtime_params_from_batch
    from crfp_torch.utils.params_io import load_params

    npz = load_params(str(CKPT))
    pt_path = tmp / "model_0_8000.pt"
    torch.save(_reference_named(npz), pt_path)
    pt = load_params(str(pt_path))
    if pt.keys() != npz.keys() or not all(torch.equal(pt[k], npz[k]) for k in npz):
        fail("the reference-named .pt does not load equal to the .npz")
    lrs, fvs = _runtime_clip(3)
    streams = {}
    for tag, sd in (("pt", pt), ("npz", npz)):
        model = CRFPRuntimeV18(ModelConfig(mid_channels=MID, dcn_window=8, dcn_window_hr=32),
                               WARP, device="cuda")
        model.load_state_dict(runtime_params_from_batch(sd, model.state_dict())[0], strict=True)
        streams[tag] = _runtime_frames(model.eval(), lrs, fvs, 3)
    for a, b in zip(streams["pt"], streams["npz"]):
        if a.shape != (1, *HR_HW, 3) or not torch.equal(a, b):
            fail("frames of the .pt and the .npz weights differ")
    print(f"[tools] conversion: {len(pt)} tensors under the reference's names ({pt_path.name}, "
          "module. prefix, state_dict entry) load equal to the .npz; 3 frames at 1080p / warp "
          f"{WARP} bit-equal")
    with torch.inference_mode():
        a, b = (x.permute(0, 3, 1, 2).contiguous() for x in (lrs[1], lrs[0]))
        flow = model.compute_flow(a, b)
    return streams, flow


def _tools_runtime() -> dict:
    """tools/test_runtime.py in both modes and tools/bench.py's three
    protocols, launch counts asserted. Returns the per-stage seconds."""
    from crfp_torch.tools import bench
    from crfp_torch.tools import test_runtime

    def per_rep(reps):  # a rep: step0 (C 1), then 4 steps (A 4, B 2, C 1 each)
        return _expect(dcn_fwd=16 * reps, flow_warp=8 * reps, emit=5 * reps)

    argv = ["--bf16", "--dcn_window", "8", "--dcn_window_hr", "32"]
    out = {}
    for mode, extra, reps in (("per stage", [], 30), ("fused", ["--fused"], 10 + 2 * 20)):
        before = _counts()
        res = test_runtime.main(argv + extra)
        got = _since(before)
        print(f"[tools] test_runtime {mode}: {res}; launches {got}")
        if got != per_rep(reps):
            fail(f"test_runtime {mode} launch counts {got} != expected {per_rep(reps)}")
        out[mode] = res
    print(f"[tools] stage_seconds (per-stage mode, 1080p warp 720^2 bf16): "
          f"{json.dumps(out['per stage'].stage_seconds)}")
    before = _counts()
    t0 = time.perf_counter()
    line = bench.run()
    got = _since(before)
    reps = sum(warm + 2 * (n - warm) for *_, n, warm in bench.PROTOCOLS)
    print(f"[tools] tools.bench, root bench.py's three protocols (no cut): "
          f"{time.perf_counter() - t0:.1f} s; launches {got}")
    print(json.dumps(line))
    if got != per_rep(reps):
        fail(f"tools.bench launch counts {got} != expected {per_rep(reps)}")
    return out["per stage"].stage_seconds


def _tools_trace(tmp: Path) -> None:
    """The trace table of 10 serving frames in a child process (no CUDA
    graph before it there); kernels A, B and C must be in it."""
    r = subprocess.run([sys.executable, "-m", "crfp_torch.bench.trace_table", "--frames",
                        "10", "--logdir", str(tmp / "trace")], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    print("\n".join(f"[tools] trace | {line}" for line in r.stdout.splitlines()[:45]))
    if r.returncode:
        fail(f"trace table exited {r.returncode}: {r.stderr[-2000:]}")
    from crfp_torch.bench.trace_table import parse_trace

    # every row of the child's trace (it prints the top 40)
    rows = parse_trace(str(tmp / "trace"), 10, top=10**6)
    for kernel in ("dcn_fwd_kernel", "flow_warp_kernel", "emit_kernel"):
        hits = [(n, ms) for n, ms in rows if kernel in n]
        if not hits:
            fail(f"the trace table lacks {kernel}")
        print(f"[tools] trace: {kernel} {sum(ms for _, ms in hits):.4f} ms a frame "
              f"({len(hits)} name(s))")
    print(f"[tools] trace: {len(rows)} kernel names, {sum(ms for _, ms in rows):.3f} ms "
          "of device time a frame")


def _tools_video(tmp: Path, streams: dict, flow) -> None:
    """flow_to_color on a flow computed on the card; combine_gifs on GIFs of
    emitted frames (the .pt and the .npz streams, their top-left 256^2)."""
    import numpy as np

    from crfp_torch.tools.video import combine_gifs, flow_to_color, frames_to_gif, read_gif

    img = flow_to_color(flow[0].permute(1, 2, 0).float().cpu().numpy())
    want = (WARP[0] // 8, WARP[1] // 8, 3)
    if img.shape != want or img.dtype != np.uint8 or img.min() == img.max():
        fail(f"flow_to_color gave {img.shape} {img.dtype} range [{img.min()}, {img.max()}]")
    paths = []
    for tag, frames in streams.items():
        u8 = [(f[0, :256, :256].clamp(0, 1) * 255).round().byte().cpu().numpy()
              for f in frames]
        paths.append(str(tmp / f"{tag}.gif"))
        frames_to_gif(u8, paths[-1])
    combine_gifs(paths, str(tmp / "both.gif"))
    both = read_gif(str(tmp / "both.gif"))
    if len(both) != 3 or any(f.shape != (256, 512, 3) or not np.array_equal(
            f[:, :256], f[:, 256:]) for f in both):
        fail("combine_gifs: wrong frames, or the two equal halves differ")
    print(f"[tools] video: flow_to_color {img.shape} of a flow computed on the card; "
          f"combine_gifs of two 3-frame GIFs of emitted frames -> {len(both)} frames "
          f"{both[0].shape}, halves equal (the mp4 tools need cv2: held by the CPU tests)")


def _since(before: dict) -> dict:
    """The launches since the counts ``before``."""
    now = _counts()
    return {k: now[k] - before[k] for k in now}


def phase_tools() -> dict:
    """Phase 11: the tools and benches on the card. Returns the launch
    counts over the phase (the trace table's child process excluded)."""

    def lap(what, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[time] phase 11 {what}: {time.perf_counter() - t0:.1f} s")
        return out

    _zero_counts()
    with tempfile.TemporaryDirectory(prefix="crfp_tools_") as d:
        tmp = Path(d)
        lap("capability", _tools_capability)
        lap("window quality", _tools_quality)
        streams, flow = lap("conversion", _tools_convert, tmp)
        lap("runtime CLIs", _tools_runtime)
        lap("trace table", _tools_trace, tmp)
        lap("video", _tools_video, tmp, streams, flow)
    total = _counts()
    print(f"[tools] launches over phase 11: {total}")
    return total


def timed(name, phase, *args):
    """Run ``phase(*args)`` and print its wall time (host clock)."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1, 2 and 5 only (build, kernels against their plain "
                         "versions, device and call times), then a {\"modes\": [...]} "
                         "line; prints no final ok line")
    ap.add_argument("--parallel-only", action="store_true",
                    help="phases 1 and 10 only (build, phase 9's tree, the parallel "
                         "paths); prints no final ok line")
    ap.add_argument("--tools-only", action="store_true",
                    help="phases 1 and 11 only (build, the tools and benches); prints "
                         "no final ok line")
    args = ap.parse_args(argv)
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
    for ckpt in (CKPT, GATE_CKPT, MID16_CKPT):
        if not ckpt.exists():
            fail(f"missing {ckpt}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; python {sys.version.split()[0]}")
    phase_build()
    if args.parallel_only:
        with tempfile.TemporaryDirectory(prefix="crfp_main_") as tmp:
            _write_reds_tree(Path(tmp))
            timed("10 parallel", phase_parallel, Path(tmp))
        print(f"[done] parallel phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.tools_only:
        timed("11 tools", phase_tools)
        print(f"[done] tools phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    gen = torch.Generator().manual_seed(0)
    modes = timed("2 kernels", phase_kernels, gen)
    if args.kernels_only:
        modes += phase_kernels_train(gen)
        print(f"[done] kernel phases passed in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"modes": modes}))
        return 0
    serve_launches = timed("3 slice", phase_slice)
    timed("3b mid16", phase_mid16)
    variant_launches = timed("3c variants", phase_variants)
    model_launches = timed("3d models", phase_models)
    timed("4 bench", phase_bench)
    modes += timed("5 train kernels", phase_kernels_train, gen)
    timed("6 train", phase_train)
    train_launches = timed("7 train bench", phase_train_bench)
    gate_launches = timed("8 gate", phase_gate)
    with tempfile.TemporaryDirectory(prefix="crfp_main_") as tmp:
        main_launches = timed("9 main", phase_main, Path(tmp))
        par_launches = timed("10 parallel", phase_parallel, Path(tmp))
    tools_launches = timed("11 tools", phase_tools)

    kernels = []
    serve = "main-path calls per steady-state frame of the serving slice, bf16 inputs"
    train = "main-path calls per amp train step (B 2, T 7, GT 192, mid 32), bf16 inputs"
    gate = ("main-path calls per steady DEPLOY frame of the 720p deployment gate "
            "(bf16, windows 8/32, dcn_fused)")
    meta = {
        "dcn_fwd": ("crfp_torch/csrc/dcn_fwd.cu", "crfp_tpu/ops/pallas/dcn.py:59",
                    "crfp_tpu/ops/pallas/dcn.py::_dcn_kernel", serve),
        "flow_warp": ("crfp_torch/csrc/flow_warp.cu", "crfp_tpu/ops/pallas/warp.py:29",
                      "crfp_tpu/ops/pallas/warp.py::flow_warp_windowed_pallas "
                      "(_dcn_kernel at k=1)", serve),
        "emit": ("crfp_torch/csrc/emit.cu", "crfp_tpu/ops/pallas/emit.py:55",
                 "crfp_tpu/ops/pallas/emit.py::_emit_kernel", serve),
        "dcn_bwd": ("crfp_torch/csrc/dcn_bwd.cu", "crfp_tpu/ops/pallas/dcn.py:219",
                    "crfp_tpu/ops/pallas/dcn.py::_dcn_bwd_kernel", train),
        "flow_warp_bwd": ("crfp_torch/csrc/flow_warp_bwd.cu",
                          "crfp_tpu/ops/pallas/dcn.py:219",
                          "crfp_tpu/ops/pallas/dcn.py::_dcn_bwd_kernel at k=1, no mask "
                          "(the windowed warp's backward)", train),
        "dcn_fused": ("crfp_torch/csrc/dcn_fused.cu", "crfp_tpu/ops/pallas/dcn.py:1468",
                      "crfp_tpu/ops/pallas/dcn.py::_dcn_kernel_fusedprep", gate),
        "ssim": ("crfp_torch/csrc/ssim.cu", "crfp_tpu/ops/pallas/ssim.py:55",
                 "crfp_tpu/ops/pallas/ssim.py::_ssim_kernel", train),
    }
    path_launches = {serve: serve_launches, train: train_launches, gate: gate_launches}
    for name, (src, replaces, tpu, per) in meta.items():
        ms = [m for m in modes if m["kernel"] == name]
        on_path = [m for m in ms if m["calls"] > 0]

        def per_unit(key):
            if any(m[key] is None for m in on_path):
                return None
            return sum(m[key] * m["calls"] for m in on_path)

        has_lib = all(m["library_ms"] is not None for m in on_path)

        def lib_unit(key):
            return per_unit(key) if has_lib else None

        serving = per is serve
        extra = {k: per_unit(k) for k in ("prologue_a_ms", "prologue_a_device_ms",
                                          "nhwc_device_ms", "step_device_ms",
                                          "masked_ssim_device_ms")
                 if all(k in m for m in on_path)}
        # A at the training shapes: its time per amp train step
        in_step = [m for m in ms if m.get("calls_per_step")]
        for key in ("device_ms", "call_ms", "bound_ms") if in_step else ():
            extra[f"train_step_{key}"] = sum(m[key] * m["calls_per_step"] for m in in_step)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "tpu_counterpart": tpu,
            # launches on this kernel's own main path: the 5-frame serving
            # slice (phase 3), the 13 amp steps of the train bench (phase 7)
            # or the gate's run (phase 8)
            "launches": path_launches[per][name],
            **({"launches_train": train_launches[name]} if serving else {}),
            "launches_gate": gate_launches[name],
            # over the train run of python -m crfp_torch.main at train.sh's
            # recipe, its dashboard dump and its validation (phase 9)
            "launches_main": main_launches[name],
            # over the trunk variants' kernel runs (phase 3c) and over the
            # other models' (phase 3d)
            "launches_variants": variant_launches[name],
            "launches_models": model_launches[name],
            # rank 0 of phase 10: its 2 data-parallel steps and its bands of
            # the height-sharded runner's 3 + 3 frames
            "launches_parallel": par_launches[name],
            # over phase 11: the capability ablation and its plain check, the
            # window-quality harnesses, the converted checkpoint, the runtime
            # CLIs and the video tools (the trace table's child excluded)
            "launches_tools": tools_launches[name],
            "max_abs_err": max(m["max_abs_err"] for m in ms),
            # ms, plain_ms and library_ms are call times (an eager loop
            # between two events: the larger of host and device time);
            # the *device_ms are replays of a CUDA graph of the same calls
            "ms": per_unit("ms"), "call_ms": per_unit("call_ms"),
            "device_ms": per_unit("device_ms"),
            "plain_ms": per_unit("plain_ms"),
            "plain_device_ms": per_unit("plain_device_ms"),
            "bound_ms": per_unit("bound_ms"),
            "bound_by": ("bytes" if all(m["bound_by"] == "bytes" for m in on_path)
                         else "operations"),
            "library_ms": lib_unit("library_ms"),
            "library_call_ms": lib_unit("library_call_ms"),
            "library_device_ms": lib_unit("library_device_ms"),
            **extra,
            "per_unit_of": per,
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
