"""Smoke run of the PyTorch/CUDA port (crfp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only    # phases 1, 2, 2b and 5 alone
    python3 chip_smoke.py --parallel-only   # phases 1 and 10 alone
    python3 chip_smoke.py --tools-only      # phases 1 and 11 alone
    python3 chip_smoke.py --models-bf16-only  # phase 1 and phase 3d's bf16 pyramids and PCD
    python3 chip_smoke.py --anchor-only     # phases 1 and 12 alone
    python3 chip_smoke.py --anchor-train-only  # phases 1 and 14 alone
    python3 chip_smoke.py --widths-only     # phases 1 and 15 alone
    python3 chip_smoke.py --anchor-per-tap-only  # phases 1 and 16 alone
    python3 chip_smoke.py --drift-only      # phases 1 and 17 alone (a reading)

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
   clamped at D = 8 and unclamped, f32 and bf16 (bf16 must take the
   tensor-core route, f32 the CUDA cores), timed unclamped in bf16 with the
   f32 device time beside it, its bound the larger of the bytes and the
   contraction at the bf16 tensor-core peak (``f32_ops_ms``: at the f32
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
   2b. kernels G and H and C's conv route (the runtime models'
   full-resolution chains) at 4 viewers, 1080p, mid 32, warp = the frame
   and 720^2, and at 1 viewer, warp 720^2 (phase_hr_conv_kernels:
   tolerances, times and bounds there);
3. drive the slice through its entry points (encode, step0, step) over 5
   frames at 1080p / warp 720^2 / mid 32 with checkpoints/v18_mid32_struct.npz,
   once through the kernels and once through the plain versions, both in
   f32; every frame must agree to >= 80 dB PSNR and max|d| <= 1e-3, and
   the launch counters must show A 4, B 2, G 1, H 1 per steady-state frame
   and C 1 a frame, by its conv route;
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
   autograd records must train through kernel D's general route (its
   gradients against the plain version's to 1e-4); PCDAlign at nf
   64, 8 groups on (1,64,180,320) (A 4); X8 plain, X8 CRA and PCD again in
   bf16 (kernel A at O = 64 on the tensor cores), kernels against plain
   versions at >= 55 dB and max|d| <= 0.05 a frame (phase 11's bf16
   limits; PCD's feature map >= 34 dB and max|d| <= 0.28), launches
   asserted, and ms per steady bf16 X8 frame; then ms per
   steady bf16 frame of the runtime models beside seeded v18 at 1080p and of
   the four pyramids (CUDA events, in order and reversed);
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
   frame; A 4 and B 3 launches a steady frame per rank), and anchored
   (checkpoints/v18_mid32_struct_anchored.npz, windows 8/32, ``hr_s2d``,
   ``dcn_anchor``: the anchored warp and DCN on the whole height with the
   whole frame's offsets, mask and flow) on phase 12's clip panning 36 / 44
   HR px a frame at 720p, where the HR warp's 32-row cell at rows 352-383
   spans the bands, against the one-process anchored ``StreamingRunner`` at
   the same limits, the checkpoint served with the clamp outside them, of
   A's and B's launches anchored 1 each a steady frame per rank; ms a step and a
   frame of the two ranks beside one process (the halo and collective
   overhead on one card, not scaling); last, one step of ``python -m
   crfp_torch.main --cpu false`` with train.sh's flags (``--num_gpu 4``;
   batch 24, the tree's 24 windows, no validation) on phase 9's tree,
   whose log must say world 1;
11. the tools and benches (crfp_torch.bench, crfp_torch.tools): the
   capability ablation (``bench.capability.run_capability``) at its
   defaults on checkpoints/{no_dcn,basic_fvsr,v18}_mid32_struct.npz (hr 768,
   20 frames x sigmas 10/50/100, mid 32, bf16, v18 at windows 8/32 with
   anchored HR windows on the s2d(4) grid, the JAX row's configuration;
   A 8, B 5 a steady frame over the three rows, F 4 a frame), its table
   printed with the card's name and power limit and its deltas beside the
   JAX package's TPU reading, like for like (a report); sigma 10's first 6
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
12. anchored HR windows (``ModelConfig.dcn_anchor``, root bench.py's
   ``_DEPLOY``): (a) kernel A in anchored shared-tap mode and kernel B in
   anchored mode on both cell grids (band 64, and band 32 for ``hr_s2d``)
   against their plain versions at (1,4,720,720), D = 32, on a smooth field
   whose cell anchors reach ±32: f32 A to 1e-4 and B to 1e-5 abs, bf16 to
   2e-2 of max|ref|, two runs and a CUDA-graph replay bit-equal, the output
   different from the clamped kernel's; device and call ms beside the
   clamped call's, the bound; (b) CRFPRuntimeV18 at 1080p / warp 720^2 /
   mid 32 with windows 8/32, ``hr_s2d`` and ``dcn_anchor`` on
   checkpoints/v18_mid32_struct_anchored.npz, 5 frames of a procedural
   clip panning 36 / 44 HR px a frame: kernels against plain versions in
   f32 (>= 80 dB, max|d| <= 1e-3 a frame) and bf16 (>= 85 dB, max|d| <=
   0.02), launches asserted (A 4, B 2, C 1 a steady frame, of them anchored
   A 1, B 1), the plain-clamp frames held outside those limits (so that the
   check fails kernels that drop the anchor), and tools.bench's anchored
   headline protocol;
14. (run after phase 12, before phase 13's lines) anchored training
   (``ModelConfig.dcn_anchor_vjp``): (a) kernel D's anchored modes, dcn_3's
   shared taps and the HR state warp's k = 1 (on the s2d and the
   full-resolution grid), against autograd of their plain versions at the
   training grid, at the amp step's (2,4,192,192) and at train.sh's
   (8,4,256,256), on a smooth field whose cell anchors reach ±32: f32 to
   1e-4 and bf16 to 2e-2 of max|ref|, d-offset, d-mask and dW (d-flow)
   bit-equal over two runs and a CUDA-graph replay, other than the clamped
   backward's; device and call ms beside the clamped call's, the plain
   version's and the bound; (b) CRFP v18 mid 32, windows 8/32, ``hr_s2d``,
   ``dcn_anchor`` + ``dcn_anchor_vjp`` from
   checkpoints/v18_mid32_struct_anchored.npz at the recipe on noise clips
   moving up to 40 HR px a frame: 3 f32 steps through the kernels against
   the plain versions (phase 6's limits), 3 amp steps likewise (losses to
   5e-3 relative, every parameter to 2*lr*steps; the clamped trunk's amp
   steps read beside them), launches asserted (per step A 48, B 36, D 24 +
   18, F 2; of them anchored A 12, B 12, D 6 + 6), ms a step of the
   anchored amp step beside the clamped one; (c) one epoch (3 steps) of
   python -m crfp_torch.main with train.sh's flags and --dcn_anchor true
   (windows 8/32) on phase 9's tree, launches asserted, its log naming the
   anchored training grid;
13. print one {"kernels": [...]} line (``launches_parallel``: rank 0's
   launches over phase 10's checked runs; ``launches_tools``: the launches
   over phase 11, its child process excluded; ``launches_anchor``: phase
   12's bf16 anchored slice; ``anchor_*``: A's and B's anchored modes per
   steady frame of it; ``launches_anchor_train``: phase 14(b)'s anchored
   amp kernel steps; and the entries ``dcn_bwd_anchored`` and
   ``flow_warp_bwd_anchored``, kernel D's anchored modes, their launches
   the anchored-mode ones of those steps, their times per anchored amp
   step; ``dcn_*_general``, the general routes of A, D and E (phase 15),
   per unit of their own main path at mid 24; ``dcn_fwd_tap_anchored`` and
   ``dcn_bwd_tap_anchored``, A's and D's per-tap anchored modes (phase 16),
   their launches the per-tap anchored ones of 16(c), their times per call
   at mid 32 in bf16) and, last, the {"ok": true, ...} line;
15. (run after phase 14, before phase 13's lines) every DCN width the JAX
   kernels take (``--mid_channels``, ``--dg_num``, ``--dcn_kernel``), the
   general route of kernels A, D and E: (a) each against its plain version
   at mid 8, 24, 48 and 64, ``dg_num`` 1, 2, 4 and 16 at mid 32,
   ``dcn_kernel`` 1 and 5 at mid 32 and the X8 pyramid at mid 16, dg 16,
   named by ``plan=`` (the rule's own route printed beside it), f32 and
   bf16, A and E bit-equal over two runs and a CUDA-graph replay, D's
   d-offset, d-mask and dW over two runs, at mid 32 also against the tuned
   route (the general/tuned ratio of each mode printed); dcn_3's anchored
   shared taps at mid 24 and 64 (A forward, D backward against autograd of
   the plain version, different from the clamp); device and call ms beside
   the bound, each record naming the general route's branch and its
   fraction of the bound; A also at the mid-24 amp step's planes, ms a
   step; A and E also timed with f32 x at mid 24, 48 and dg 16; D's chunked
   branch forced at mid 24 (per-tap and dcn_3) on the same operands and
   limits, its d-offset, d-mask and dW over two runs; (b) the paths at full
   width, seeded weights, kernels against plain versions, launches and their
   general-route share asserted: v18 serving (1080p / warp 720^2, t 5) at mid
   24 and 64 (f32 >= 80 dB, max|d| <= 1e-3 a frame; bf16 between the sound
   readings and a planted fault's, beside mid 32 in bf16 through the tuned
   and the forced general route on the same weights), the gate's
   StreamingRunner at mid 24 (EXACT and DEPLOY with ``dcn_fused``, f32 at
   phase 3's limits, DEPLOY bf16 at phase 8's 60 dB),
   anchored serving at mid 24 (``_DEPLOY``; the plain clamp outside the
   limits), one f32 train step of the recipe at mid 24, mid 64, ``dg_num``
   16 and ``dcn_kernel`` 5 (phase 6's limits) and one amp step each
   (finite), one anchored f32 step at mid 24, one step of ``python -m
   crfp_torch.main`` at ``--mid_channels 24``;
16. (run after phase 15, before phase 13's lines) per-tap anchored windows
   (``DCNAlign(anchor=True)`` as a per-tap stage, which no model of the JAX
   package sets): (a) kernel A in per-tap anchored mode against its plain
   version on the inference and the training grid at (1,32,180,180) and
   (1,16,180,180) (tuned), (1,24,180,180) (general), G 8, and (1,64,180,320)
   at 8, 4, 16 and 64 channels a group (O = 64; G 8, 16, 4, 1), D 8, on a
   smooth field whose cell anchors reach past ±8: f32 to 1e-4 abs, bf16 to
   2e-2 of max|ref| (phase 12(a)'s limits), two runs and a CUDA-graph replay
   bit-equal, the output other than the clamped call's by more than the
   limit; device and call ms beside the bound and the clamped call's;
   (b) kernel D in per-tap anchored mode at (2,32,48,48) (tuned) and
   (2,24,48,48) (general) on the training grid: dx, d-offset, d-mask and dW
   against autograd of the plain version (phase 14(a)'s limits), d-offset,
   d-mask and dW bit-equal over two runs, d-offset other than the clamped
   call's, ms as (a); (c) ``DCNAlign(anchor=True, anchor_vjp=True)`` as a
   per-tap stage at mid 32, seeded, f32, 3 Adam steps at (2,32,48,48)
   through the kernels against the plain versions (every leaf's gradient of
   the first step to 1e-4 of its max|ref|, as phase 14 holds D, then phase
   6's limits), the counts zeroed just before and read just after: 3 per-tap
   anchored launches of A and of D, and an inference call at (1,32,180,180)
   at (a)'s limit.
17. (``--drift-only`` alone: a reading, not held) where the amp step's
   ~1e-3 drift from the plain versions comes from: phase 14(b)'s anchored
   amp steps and the clamped ones it reads beside them, through the
   kernels with each of A (the DCN forward), D (the DCN backward), B (the
   warp, forward and backward) and F (the SSIM map) in turn swapped for its
   plain version, every loss beside the all-plain run's.

Imports nothing of JAX or of crfp_tpu.
"""

from __future__ import annotations

import contextlib
import copy
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
def plain_kernels(hr_chains: bool = True):
    """Route the models', the metric's and the zone evaluator's kernel call sites to the plain
    versions (they call the dispatchers by these module-level names); on
    the plain versions autograd of plain PyTorch applies. ``hr_chains``
    False keeps the runtime models' full-resolution chains (G, H and C's
    conv route) on their kernels: for the bf16 comparisons of A, B and E
    through the runtime models, whose limits hold the kernels under test to
    the plain versions where the rest of the frame is computed alike on both
    sides. G, H and C's conv route replace cuDNN's bf16 convolutions, whose
    sums round in another order (a bf16 step at some pixels, 67 dB on the
    anchored slice's cold frame); phase 2b holds them to the exact answer,
    phases 3 and 3d in f32 at the runtime level."""
    import crfp_torch.eval.flow_warp_eval as fw
    import crfp_torch.eval.zones as zn
    import crfp_torch.models.crfp as cr
    import crfp_torch.models.pyramid as py
    import crfp_torch.models.runtime as rt
    import crfp_torch.nn.align as al
    import crfp_torch.ops.metrics as mt
    from crfp_torch.ops.cuda.emit import emit_frame_conv_ref, emit_frame_ref
    from crfp_torch.ops.cuda.hr_conv import hr_conv_head_ref, hr_conv_tail_ref
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
    if hr_chains:
        sites += [(rt, "emit_frame_conv", emit_frame_conv_ref),
                  (rt, "hr_conv_head", hr_conv_head_ref),
                  (rt, "hr_conv_tail", hr_conv_tail_ref)]
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

    # ---- C: r=1 and r=4 (the s2d frame); the pixel route at a width that is
    # not a multiple of 8 and on y read through a view offset by one element
    # (misaligned), which must give the row route's bits. The last two draw
    # from a generator of their own, so that every later mode gets the
    # operands it got before they were added. No mode is on the serving
    # slice's path, whose frame takes C's conv route (phase 2b); ``main``:
    # the 1080p frame of the runtime models' plain finish (grad on, or
    # last_channels outside the conv route's) ----------------------------
    own = torch.Generator().manual_seed(7)
    for mode, (r, hw, lr_hw, offset, main, g_) in {
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
        # the runtime models' 1080p frame takes the row route in both types
        if main and not all(p.vector for p in plans):
            fail(f"kernel C {mode}: the 1080p frame takes the pixel route {plans}")
        if offset and (any(p.vector for p in plans)
                       or not (torch.equal(got, aligned[0]) and torch.equal(gotb, aligned[1]))):
            fail(f"kernel C {mode}: the pixel route {plans} differs from the row route")
        if not (torch.equal(emit.emit_frame(yb, lrb, r), gotb)
                and torch.equal(captured(lambda: emit.emit_frame(yb, lrb, r)), gotb)):
            fail(f"kernel C {mode}: two runs and a CUDA-graph replay are not bit-equal")
        k_ms = measure(lambda: emit.emit_frame(yb, lrb, r))
        p_ms = measure(lambda: emit.emit_frame_ref(yb, lrb, r), iters=5)
        bnd = bound([yb, lrb], [gotb], 10 * hw[0] * hw[1] * 3, "bfloat16")
        record("emit", mode, 0, err, rel, k_ms, p_ms, None, bnd,
               bound_fraction=bnd[0] / k_ms[1],
               route="row" if plans[1].vector else "pixel", digest=digest(got, gotb))
    return modes


def phase_hr_conv_kernels():
    """Phase 2b: kernels G and H and kernel C's conv route (the runtime
    models' full-resolution chains) against their plain versions on 4
    viewers at 1080p, mid 32 (L 4), warp = the frame (the stream cells'
    step, ``calls_stream``) and 720^2, and on 1 viewer at 720^2 (the serving
    slice's frame, phase 3: ``calls``). f32 operands to 2e-5 of max|ref| (TF32
    off: only the order of f32 sums differs). bf16: the chains round their
    stored intermediates to bf16 where the module path does, and a sum taken
    in another order can land a bf16 step away at each, so the kernel's gap
    to the plain version in f32 on the same bf16 operands and weights must be
    at most twice the bf16 module chain's gap to it plus 2^-8 of max|ref|;
    C's state bit-equal. G's offset is held as its residual, offset - flow
    (the flow passes through exactly and would set max|ref|), apart from the
    mask. Two runs and a CUDA-graph replay bit-equal. Timed in bf16 beside
    the plain version on f32 operands and, as the library, the module chain
    on the bf16 operands (cuDNN and PyTorch's passes; for C, kernel C's row
    route after cuDNN's ``conv_last``), with the f32 kernel's device time
    beside them. Bounds: bytes at 3.35 TB/s against the FMAs at the bf16
    peak (bytes set it); ``fma_f32_ms``: the FMAs at the f32 CUDA-core rate
    the kernels issue them at, their own design's limit, not the card's.
    Returns the records."""
    import torch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.ops.cuda import emit, hr_conv

    modes = []
    record = functools.partial(_record, modes)
    gen = torch.Generator().manual_seed(22)
    (H, W), last = HR_HW, MID // 8

    def rel(got, ref):
        return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())

    # (viewers, warp, calls per serving-slice frame, calls per stream-cell step)
    for n, warp, calls, calls_stream in ((4, (H, W), 0, 1), (4, WARP, 0, 0), (1, WARP, 1, 0)):
        model = CRFPRuntimeV18(ModelConfig(mid_channels=MID, dcn_window=8, dcn_window_hr=32),
                               warp_size=warp, device="cpu")
        with torch.no_grad():  # heads off their zero init, so the offsets move
            for conv in (model.dcn_3.dcn_offset.conv, model.dcn_3.dcn_mask.conv):
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.3)
                conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen) * 0.3)
        # f32; bf16; the bf16 weights in f32 (the bf16 operands' exact answer)
        models = {"f32": model.cuda().eval()}
        models["bf16"] = copy.deepcopy(models["f32"]).to(torch.bfloat16)
        models["exact"] = copy.deepcopy(models["bf16"]).float()
        wph, wpw = warp
        ops = {"f32": {"u": torch.randn(n, 16 * last, H // 4, W // 4, generator=gen),
                       "hw": torch.randn(n, last, wph, wpw, generator=gen) * 0.5,
                       "flow": torch.randn(n, 2, wph, wpw, generator=gen) * 3,
                       "p": torch.randn(n, 16 * last, wph // 4, wpw // 4, generator=gen) * 0.3,
                       "aligned": torch.randn(n, last, wph, wpw, generator=gen) * 0.5,
                       "lv3": torch.randn(n, last, H, W, generator=gen),
                       "lr": torch.rand(n, 3, *LR_HW, generator=gen)}}
        ops["f32"] = {k: v.cuda() for k, v in ops["f32"].items()}
        ops["bf16"] = {k: v if k == "flow" else v.to(torch.bfloat16)
                       for k, v in ops["f32"].items()}
        ops["exact"] = {k: v.float() for k, v in ops["bf16"].items()}
        tag = f"({n},{last},{H},{W}) warp {wph}x{wpw}"

        def calls_of(kind):
            m, o = models[kind], ops[kind]
            return {
                "hr_conv_head": (
                    lambda: hr_conv.hr_conv_head(m.dcn_3, o["u"], o["hw"], o["flow"], o["p"], warp),
                    lambda: hr_conv.hr_conv_head_ref(m.dcn_3, o["u"], o["hw"], o["flow"], o["p"],
                                                     warp),
                    [o["u"], o["hw"], o["flow"], o["p"]], 9 * last * (5 * last + 5) * wph * wpw * n,
                    "dcn_3's 5 head convs + shuffle, lrelus, cats, tanh, sigmoid"),
                "hr_conv_tail": (
                    lambda: hr_conv.hr_conv_tail(m.forward_resblocks_3, o["u"], o["aligned"], None,
                                                 warp),
                    lambda: hr_conv.hr_conv_tail_ref(m.forward_resblocks_3, o["u"], o["aligned"],
                                                     None, warp),
                    [o["u"], o["aligned"]], 9 * last * 4 * last * H * W * n,
                    "forward_resblocks_3's 4 convs + shuffle, lrelu, cat, relu, add"),
                "emit_conv": (
                    lambda: emit.emit_frame_conv(o["lv3"], m.conv_last, o["lr"], warp),
                    lambda: emit.emit_frame_conv_ref(o["lv3"], m.conv_last, o["lr"], warp),
                    [o["lv3"], o["lr"]], 9 * last * 3 * H * W * n,
                    "lrelu + conv_last + kernel C's row route",
                    lambda: emit.emit_frame_conv_ref(o["lv3"], m.conv_last, o["lr"], warp,
                                                     emit=emit.emit_frame)),
            }

        def residual(kernel, outs, kind):
            # G's offset less the flow it adds (y, x order), beside the mask
            if kernel != "hr_conv_head":
                return outs
            return (outs[0] - ops[kind]["flow"].flip(1).float(), *outs[1:])

        def tup(x):
            return x if isinstance(x, tuple) else (x,)

        with torch.inference_mode():
            cf, cb, ce = calls_of("f32"), calls_of("bf16"), calls_of("exact")
            for kernel in cf:
                k32, p32 = cf[kernel][:2]
                k16, p16, ins, fmas, lib_what, *lib = cb[kernel]
                lib16 = lib[0] if lib else p16
                got, want = (residual(kernel, tup(f()), "f32") for f in (k32, p32))
                gotb, wantb = (residual(kernel, tup(f()), "bf16") for f in (k16, p16))
                best = residual(kernel, tup(ce[kernel][1]()), "exact")
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                for a, b in zip(got, want):
                    if not rel(a, b) <= 2e-5:
                        fail(f"{kernel} {tag}: f32 max|d| {rel(a, b)} of max|ref| > 2e-5")
                pairs = list(zip(gotb, wantb, best))
                if kernel == "emit_conv":
                    if not torch.equal(gotb[0], wantb[0]):
                        fail(f"{kernel} {tag}: the bf16 state differs from the plain version's")
                    pairs = pairs[1:]
                for a, b, e in pairs:
                    if not rel(a, e) <= 2 * rel(b, e) + 2 ** -8:
                        fail(f"{kernel} {tag}: bf16 gap {rel(a, e)} to the exact answer over "
                             f"twice the module chain's {rel(b, e)} + 2^-8")
                krel = max(rel(a, e) for a, _, e in pairs)
                mrel = max(rel(b, e) for _, b, e in pairs)
                first = tup(k16())
                again = tup(k16())
                replay = captured(lambda: tup(k16())[0])
                if not (all(torch.equal(a, b) for a, b in zip(again, first))
                        and torch.equal(replay, first[0])):
                    fail(f"{kernel} {tag}: two runs and a CUDA-graph replay are not bit-equal")
                k_ms = measure(k16)
                p_ms = measure(p32, iters=5)
                lib_ms = measure(lib16, iters=5)
                f32_dev = device_time_ms(k32)
                bnd = bound(ins, gotb, 2 * fmas, "bfloat16")
                fma_ms = 2 * fmas / PEAK_FLOPS["float32"] * 1e3
                record(kernel, tag, calls, err, krel, k_ms, p_ms, lib_ms, bnd,
                       calls_stream=calls_stream, module_bf16_rel=mrel, f32_device_ms=f32_dev,
                       bound_fraction=bnd[0] / k_ms[1], fma_f32_ms=fma_ms,
                       fma_fraction=fma_ms / k_ms[1], library=lib_what,
                       digest=digest(*first))
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
    bits in two runs and from a CUDA-graph replay; bf16 must plan the
    tensor-core route (``mma`` in the record's ``tile``), f32 the CUDA
    cores; timed in bf16 unclamped (the pyramids' default), with the f32
    kernel's device time beside it.
    The bound takes the larger of the bytes at 3.35 TB/s and the
    contraction's 2 * 9 * C * O FLOP a pixel at the bf16 tensor-core peak;
    ``f32_ops_ms`` is the same FLOP at the f32 CUDA-core peak, the rate of
    the f32 route."""
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
        if not plan.mma or dcn.tile_plan(1, c, *hw, o, g, None, bf16=False).mma:
            fail(f"kernel A {mode}: bf16 must plan the tensor cores, f32 the CUDA cores")
        _record(out, "dcn_fwd", mode, 0, err, rel, k_ms, p_ms, None, bnd,
                calls_per_x8_frame=calls, f32_device_ms=f32_dev, f32_ops_ms=f32_ops,
                bound_fraction=bnd[0] / k_ms[1], f32_ops_fraction=f32_ops / f32_dev,
                tile=f"{plan.tile_h}x{plan.tile_w} pad {plan.pad}{' mma' if plan.mma else ''}",
                digest=digest(*bits))
    return out



def _zero_counts() -> None:
    from crfp_torch.ops.cuda import dcn, dcn_fused, emit, hr_conv, ssim, warp

    dcn.launches = warp.launches = emit.launches = dcn_fused.launches = 0
    hr_conv.head_launches = hr_conv.tail_launches = emit.conv_launches = 0
    dcn.bwd_launches = warp.bwd_launches = ssim.launches = 0
    dcn.anchor_launches = warp.anchor_launches = 0
    dcn.bwd_anchor_launches = warp.bwd_anchor_launches = 0
    dcn.general_launches = dcn.bwd_general_launches = dcn_fused.general_launches = 0
    dcn.tap_anchor_launches = dcn.bwd_tap_anchor_launches = 0


def _counts() -> dict:
    from crfp_torch.ops.cuda import dcn, dcn_fused, emit, ssim, warp

    return {"dcn_fwd": dcn.launches, "flow_warp": warp.launches,
            "emit": emit.launches, "dcn_bwd": dcn.bwd_launches,
            "flow_warp_bwd": warp.bwd_launches, "dcn_fused": dcn_fused.launches,
            "ssim": ssim.launches}


def _hr_counts() -> dict:
    """The launches of G, H and C's conv route (a part of :func:`_counts`'s
    ``emit``): the runtime models' full-resolution chains."""
    from crfp_torch.ops.cuda import emit, hr_conv

    return {"hr_conv_head": hr_conv.head_launches, "hr_conv_tail": hr_conv.tail_launches,
            "emit_conv": emit.conv_launches}


def _hr_expect(steady: int, frames: int) -> dict:
    """:func:`_hr_counts` of a runtime model's ``frames`` frames outside
    autograd, ``steady`` of them steady steps: G and H a steady step, C's
    conv route every frame."""
    return {"hr_conv_head": steady, "hr_conv_tail": steady, "emit_conv": frames}


def _anchor_counts() -> dict:
    """The anchored-mode launches of A, B and D (a part of :func:`_counts`'s)."""
    from crfp_torch.ops.cuda import dcn, warp

    return {"dcn_fwd": dcn.anchor_launches, "flow_warp": warp.anchor_launches,
            "dcn_bwd": dcn.bwd_anchor_launches, "flow_warp_bwd": warp.bwd_anchor_launches}


def _general_counts() -> dict:
    """The general-route launches of A, D and E (a part of :func:`_counts`'s)."""
    from crfp_torch.ops.cuda import dcn, dcn_fused

    return {"dcn_fwd": dcn.general_launches, "dcn_bwd": dcn.bwd_general_launches,
            "dcn_fused": dcn_fused.general_launches}


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
    ``db_min`` and max|d| <= ``d_max`` (None: not held). Returns each
    frame's (PSNR, max|d|)."""
    import torch

    readings = []

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
        readings.append((psnr, float(d.max())))
    return readings


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
    launches = {**_counts(), **_hr_counts()}
    expect = {**_expect(dcn_fwd=4 * (t - 1), flow_warp=2 * (t - 1), emit=t),
              **_hr_expect(t - 1, t)}
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


def _models_vs_plain(tag, run, expect, total, shape, db_min=80.0, d_max=1e-3):
    """``run()`` through the kernels (launch counts equal to ``expect``),
    then through the plain versions: >= ``db_min`` dB and max|d| <=
    ``d_max`` per frame. Adds the kernel run's launches to ``total``;
    returns the kernels' frames."""
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
    _frames_agree(f"[models] {tag}", got, want, db_min, d_max, shape=shape)
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
        # the plain run launches none of G, H and C's conv route
        if _hr_counts() != _hr_expect(steady, MODEL_FRAMES):
            fail(f"models runtime {kind}: G, H and C's conv route launched {_hr_counts()} "
                 f"!= expected {_hr_expect(steady, MODEL_FRAMES)}")
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
    # records trains through kernel D's general route (O = 64)
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    gen64 = torch.Generator().manual_seed(64)
    ops64 = [t.cuda() for t in (torch.randn(1, PYR_MID, 16, 16, generator=gen64),
                                torch.randn(1, 18 * 16, 16, 16, generator=gen64) * 2,
                                torch.rand(1, 9 * 16, 16, 16, generator=gen64),
                                torch.randn(PYR_MID, PYR_MID, 3, 3, generator=gen64) * 0.05)]
    g64 = torch.randn(1, PYR_MID, 16, 16, generator=gen64).cuda()
    before = dcn.bwd_general_launches
    grads = []
    for fn in (dcn.deform_conv2d_windowed, deform_conv2d_windowed_ref):
        leaves = [t.detach().clone().requires_grad_(True) for t in ops64]
        fn(*leaves).backward(g64)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    rel64 = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(*grads))
    print(f"[models] a recorded O = 64 DCN trains through kernel D's general route: "
          f"{dcn.bwd_general_launches - before} launch, gradients within {rel64:.2e} of "
          f"max|ref| of the plain version's (limit 1e-4)")
    if dcn.bwd_general_launches != before + 1 or not rel64 <= 1e-4:
        fail("a recorded O = 64 DCN did not train through kernel D's general route")
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
    _models_bf16(total)
    lap("bf16 pyramids and PCD")

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



# bf16 frames of the pyramids and PCD, kernels against plain versions. The
# pyramids' frames: phase 11's bf16 limits (a bf16 rounding or two of the
# output, carried by the recurrence; 65.51-68.66 dB, max|d| 3.9e-3 on the
# H100 with either route of kernel A at O = 64). PCD's output is a feature
# map of range ~[-0.7, 7.7] after four chained DCNs, where a bf16 ulp is up
# to 0.03: the CUDA-core route read 44.15 dB, max|d| 0.1016, the tensor-core
# route (samples rounded to bf16, as the TPU kernel rounds them) 36.90 dB,
# 0.1406; its limits keep about 2x below the lower reading.
MODELS_BF16_DB, MODELS_BF16_DMAX = 55.0, 0.05
PCD_BF16_DB, PCD_BF16_DMAX = 34.0, 0.28


def _models_bf16(total: dict) -> None:
    """Phase 3d's bf16 half: X8 plain and X8 CRA on phase 3d's clip and PCD
    on its features, in bf16 through the kernels (kernel A at O = 64 on the
    tensor cores) and through the plain versions, >= MODELS_BF16_DB dB and
    max|d| <= MODELS_BF16_DMAX a frame (PCD: PCD_BF16_DB, PCD_BF16_DMAX),
    launches asserted (X8 A 4, B 4, C 1
    a steady frame, the cold frame C 1; PCD A 4); then ms per steady bf16
    X8 frame (CUDA events, twice). Adds the launches to ``total``."""
    import torch

    from crfp_torch.nn.pcd import PCDAlign

    bf16 = torch.bfloat16
    steady = PYR_FRAMES - 1
    x8 = {}
    for cra in (False, True):
        model = x8[cra] = _pyramid("X8", cra, dtype=bf16)
        args = _pyramid_inputs("X8", cra, PYR_FRAMES, bf16)

        def run(model=model, args=args):
            out = model(*args)  # forward runs under no_grad itself
            torch.cuda.synchronize()
            return list(out.float().unbind(1))

        _models_vs_plain(f"X8{' CRA' if cra else ''} dcn_window=None bf16", run,
                         _expect(dcn_fwd=4 * steady, flow_warp=4 * steady, emit=PYR_FRAMES),
                         total, (1, GATE_LR_HW[0] * 8, GATE_LR_HW[1] * 8, 3),
                         MODELS_BF16_DB, MODELS_BF16_DMAX)
    pcd = _perturb_dcn(PCDAlign(64, 8, device="cuda", seed=70), 71).to(bf16)
    gen = torch.Generator().manual_seed(72)
    feats = [torch.randn(1, 64, 180, 320, generator=gen).cuda().to(bf16) for _ in range(3)]
    flow = _smooth(gen, 2, (180, 320), 3.0)

    def run_pcd():
        out = pcd(*feats, flow)  # forward runs under no_grad itself
        torch.cuda.synchronize()
        return [out.float()]

    _models_vs_plain("PCD nf 64 groups 8 (1,64,180,320) bf16", run_pcd, _expect(dcn_fwd=4),
                     total, (1, 64, 180, 320), PCD_BF16_DB, PCD_BF16_DMAX)
    ms = []
    for _ in range(2):
        spans = []
        for frames in PYR_TIMED:
            args = _pyramid_inputs("X8", False, frames, bf16)
            with torch.inference_mode():
                x8[False](*args)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                x8[False](*args)
                end.record()
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end))
        ms.append((spans[1] - spans[0]) / (PYR_TIMED[1] - PYR_TIMED[0]))
    print(f"[models] X8 bf16 ms per steady frame (LR {GATE_LR_HW}, mid {PYR_MID}, "
          f"dcn_window None, CUDA events, twice): {json.dumps(ms)}")


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
        launches = {**_counts(), **_hr_counts()}
        tag = "dcn_fused" if fused else "structured"
        print(f"[bench] {tag}: {res}")
        print(f"[bench] {tag}: launches over {frames} frames ({steady} steady): {launches}")
        expect = {**(_expect(dcn_fused=3 * steady, dcn_fwd=steady, flow_warp=2 * steady,
                             emit=frames) if fused else
                     _expect(dcn_fwd=4 * steady, flow_warp=2 * steady, emit=frames)),
                  **_hr_expect(steady, frames)}
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


def _check_grads(tag, got, want, tol):
    """max|d| <= tol * max|ref| for every gradient; returns (max abs error,
    max relative error)."""
    abs_err, rel_err = 0.0, 0.0
    for i, (g_, w_) in enumerate(zip(got, want)):
        d = float((g_.float() - w_.float()).abs().max())
        rel = d / float(w_.abs().max())
        if not rel <= tol:
            fail(f"{tag}: gradient {i} max|d| {d} is {rel:.3e} of max|ref| > {tol}")
        abs_err, rel_err = max(abs_err, d), max(rel_err, rel)
    return abs_err, rel_err


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
            err = max(err, _check_grads(f"kernel D dcn {mode}", got, want, 1e-4)[0])
        xb, gb = x.to(torch.bfloat16), gout.to(torch.bfloat16)
        _, gotb = _grads(kern, (xb, off, mask, wt, bias), gb)
        torch.cuda.synchronize()
        _, rel = _check_grads(f"kernel D dcn bf16 {mode}", gotb, want, 2e-2)
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
            err = max(err, _check_grads(f"kernel D warp {mode}", got, want, 1e-4)[0])
        xb, gb = x.to(torch.bfloat16), gout.to(torch.bfloat16)
        _, gotb = _grads(kern, (xb, flow), gb)
        torch.cuda.synchronize()
        _, rel = _check_grads(f"kernel D warp bf16 {mode}", gotb, want, 2e-2)
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


def _train_vs_plain(tag, steps, lr, expect, batches, amp=False, expect_anchored=None,
                    loss_rtol=1e-4, builder=None, expect_general=None, **build_kw):
    """``steps`` train steps (f32, or ``amp``) of ``build_trainer(**build_kw)``
    (or of ``builder(**build_kw)``) through the kernels against the same
    steps through the plain versions, from the same state and batches:
    losses to ``loss_rtol`` relative (None: read, not held), every
    parameter to 2*lr*steps, the kernel path's launch counts equal to
    ``expect`` (and its anchored-mode launches to ``expect_anchored``, its
    general-route ones to ``expect_general``). Returns those counts."""
    from crfp_torch.bench.train import build_trainer

    kind = "amp" if amp else "f32"
    builder = builder or build_trainer

    def run(path):
        model, opt, step = builder(amp=amp, lr_rate=lr, **build_kw)
        t0 = time.perf_counter()
        losses = []
        for i in range(steps):
            m = step(opt, batches[i], i)
            losses.append(float(m["loss"]))
            print(f"{tag} {path} {kind} step {i}: " + ", ".join(
                f"{k} {float(v):.6f}" for k, v in m.items()))
        print(f"{tag} {path}: {steps} {kind} steps in {time.perf_counter() - t0:.2f} s "
              "(host clock, first steps)")
        return losses, {n: p.detach().clone() for n, p in model.named_parameters()}

    with plain_kernels():
        want_losses, want_params = run("plain")
    _zero_counts()
    got_losses, got_params = run("kernels")
    launches = _counts()
    if expect_general is not None:
        general = _general_counts()
        print(f"{tag} general-route launches in {steps} kernel steps: {general}")
        if general != expect_general:
            fail(f"{tag}: general-route launch counts {general} != expected {expect_general}")
    if expect_anchored is not None:
        anchored = _anchor_counts()
        print(f"{tag} anchored-mode launches in {steps} kernel steps: {anchored}")
        if anchored != expect_anchored:
            fail(f"{tag}: anchored launch counts {anchored} != expected {expect_anchored}")
    print(f"{tag} launches in {steps} kernel steps: {launches}")
    if launches != expect:
        fail(f"{tag}: launch counts {launches} != expected {expect}")
    for i, (g, w) in enumerate(zip(got_losses, want_losses)):
        if not (math.isfinite(g) and (loss_rtol is None or abs(g - w) <= loss_rtol * abs(w))):
            fail(f"{tag} train step {i}: loss {g} through the kernels, {w} plain")
    worst = max(float((got_params[k] - want_params[k]).abs().max()) for k in want_params)
    rel = max(abs(g - w) / abs(w) for g, w in zip(got_losses, want_losses))
    print(f"{tag} losses kernels {got_losses} plain {want_losses}; max relative loss "
          f"|d| {rel:.3e} (limit {loss_rtol}); max param |d| after {steps} steps "
          f"{worst:.3e} (limit {2 * lr * steps:.1e})")
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
# the anchored configuration runs checkpoints/v18_mid32_struct_anchored.npz
# on phase 12's panning clip at 720p (_par_clip): 360 HR rows a rank, so the
# HR warp's 32-row cell at rows 352-383 spans the two bands
PAR_WINDOWS = (("windows 8/32", dict(dcn_window=8, dcn_window_hr=32)),
               ("unclamped", dict(dcn_window=None, dcn_window_hr=None)),
               ("anchored", dict(dcn_window=8, dcn_window_hr=32, hr_s2d=True, dcn_anchor=True)))
PAR_JOIN_S = 300


def _par_trainer(group=None):
    """The batch CRFP of phase 6 (checkpoint, strict, windows 8/32, remat) and
    its f32 step at PAR_LR, data-parallel over ``group``."""
    from crfp_torch.bench.train import build_trainer

    return build_trainer(amp=False, ckpt=str(CKPT), lr_rate=PAR_LR, group=group)


@functools.cache
def _par_clip(anchored: bool):
    """lr, hr and masks of the parallel frames on the card: phase 3b's 720p
    gate clip, or (``anchored``) phase 12's clip panning 36 / 44 HR px a
    frame at 720p, under the gate clip's fovea masks."""
    import torch

    from crfp_torch.bench.quality_window import panning_clip

    lr, hr, masks = _variant_clip(VARIANT_FRAMES)
    if anchored:
        lr, hr = (torch.from_numpy(a).cuda()
                  for a in panning_clip(VARIANT_FRAMES, GATE_LR_HW, ANCHOR_V, seed=12))
    return lr, hr, masks


def _par_stream(runner, frames, anchored_clip=None):
    """The frames of :func:`_par_clip` (the anchored one for an anchored
    model, or as ``anchored_clip`` says) through ``runner`` and the host ms
    of each (synchronised)."""
    import torch

    anchored = runner.model.cfg.dcn_anchor if anchored_clip is None else anchored_clip
    lr, hr, masks = _par_clip(anchored)
    outs, ms = [], []
    for i in range(frames):
        t0 = time.perf_counter()
        outs.append(runner(lr[i][None], hr[i][None], masks[i][None]).float())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def _par_model(cfg, ckpt=None):
    """v18 mid 32 from the checkpoint (the anchored one for an anchored
    ``cfg``, or ``ckpt``) at the windows of ``cfg``, f32."""
    import torch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, load_npz

    ckpt = ckpt or (ANCHOR_CKPT if cfg.get("dcn_anchor") else CKPT)
    model = CRFP(ModelConfig(mid_channels=MID, **cfg), device="cuda")
    model.load_state_dict(from_jax(load_npz(str(ckpt))), strict=True)
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
            res[f"{tag} anchored"] = _anchor_counts()
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
    # the anchored checkpoint served with the clamp: its frames must fall
    # outside the limits that hold the sharded anchored frames
    clamped = {k: v for k, v in dict(PAR_WINDOWS)["anchored"].items()
               if k not in ("hr_s2d", "dcn_anchor")}
    clamp_frames, _ = _par_stream(StreamingRunner(_par_model(clamped, ANCHOR_CKPT)), PAR_FRAMES,
                                  anchored_clip=True)

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
    for tag, cfg in PAR_WINDOWS:
        # anchored: dcn_3 and the HR warp, each once a steady frame
        n_anch = steady if cfg.get("dcn_anchor") else 0
        anch_expect = {"dcn_fwd": n_anch, "flow_warp": n_anch, "dcn_bwd": 0,
                       "flow_warp_bwd": 0}
        for r, res in enumerate(ranks):
            print(f"[parallel] spatial {tag}: rank {r} launches over {PAR_FRAMES} frames "
                  f"{res[f'{tag} launches']} (A {4} and B {3} a steady frame, one launch "
                  f"a call on its slab), anchored {res[f'{tag} anchored']}")
            if res[f"{tag} launches"] != frame_expect or res[f"{tag} anchored"] != anch_expect:
                fail(f"parallel spatial {tag} rank {r}: launches {res[f'{tag} launches']} "
                     f"!= {frame_expect} or anchored {res[f'{tag} anchored']} != "
                     f"{anch_expect}")
        if len({res[f"{tag} digest"] for res in ranks}) != 1:
            fail(f"parallel spatial {tag}: the ranks returned different frames")
        got = [f.cuda() for f in ranks[0][f"{tag} frames"]]
        _frames_agree(f"[parallel] spatial {tag}", got, want_frames[tag],
                      versus="2 ranks vs StreamingRunner",
                      shape=(1, GATE_LR_HW[0] * 8, GATE_LR_HW[1] * 8, 3))
        if cfg.get("dcn_anchor"):
            readings = _frames_agree(f"[parallel] spatial {tag} vs the clamp", got[1:],
                                     clamp_frames[1:], -math.inf, None,
                                     versus="2 ranks anchored vs one process clamped")
            inside = [i + 1 for i, (p, d) in enumerate(readings) if p >= 80.0 and d <= 1e-3]
            if inside:
                fail(f"parallel spatial anchored: the clamped frames {inside} fall inside the "
                     "limit (>= 80 dB, max|d| <= 1e-3), which then cannot fail a runner that "
                     "drops the anchor")

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
          f"mid {MID}, bf16, v18 windows 8/32 anchored on the s2d(4) grid (as the JAX "
          f"row), held-out seeds from 9000: "
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


# ---- phase 12: anchored HR windows (ModelConfig.dcn_anchor) ---------------

ANCHOR_CKPT = ROOT / "checkpoints" / "v18_mid32_struct_anchored.npz"
# the clip pans this many LR px a frame: 36 and 44 px at the HR level, past
# the window D = 32 of dcn_3 and the HR state warp
ANCHOR_V, ANCHOR_FRAMES = (4.5, -5.5), 5
# kernels against plain versions on the anchored slice in bf16, a frame:
# between the kernels' readings (>= 89.44 dB, max|d| <= 7.8e-3 on the H100)
# and the plain-clamp frames' (<= 80.06 dB, >= 0.045), so that the limit
# fails kernels that drop the anchor
ANCHOR_BF16_DB, ANCHOR_BF16_DMAX = 85.0, 0.02


def _anchor_kernels(gen) -> list:
    """Phase 12(a): kernel A in anchored shared-tap mode and kernel B in
    anchored mode (both cell grids) against their plain versions at the
    serving shape (1,4,720,720), D = 32, on a smooth field whose cell means
    reach past ±32: f32 A to 1e-4 and B to 1e-5 abs, bf16 to 2e-2 of
    max|ref|; two runs and a CUDA-graph replay bit-equal; the output must
    differ from the clamped kernel's on the same operands. Times beside the
    clamped call and beside the anchor table in PyTorch ops (the plain
    version of the call's table pre-pass). Records carry ``calls_anchor``:
    calls per steady frame of the anchored slice (the JAX deployment's s2d
    grid for B)."""
    import torch

    from crfp_torch.ops import anchor as an
    from crfp_torch.ops.cuda import dcn, warp
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    modes = []
    record = functools.partial(_record, modes)
    d, hw, c = 32, WARP, MID // 8
    n_px = hw[0] * hw[1]

    def field():
        # std 40 px, varying over ~32 px, plus 1 px of noise
        return (_smooth(gen, 2, hw, 40.0)
                + (torch.randn(1, 2, *hw, generator=gen)).cuda()).contiguous()

    def beyond(off, geom, what):
        table = an.anchor_table(off, geom, 1)
        reach = float(table.abs().max())
        print(f"[anchor] {what}: anchors up to {reach:g} px (A = {geom.a_y}/{geom.a_x}), "
              f"|offset| up to {float(off.abs().max()):.1f} px")
        if reach < d:
            fail(f"{what}: no cell's anchor reaches D = {d}")

    def same_bits(tag, fn, first):
        if not (torch.equal(fn(), first) and torch.equal(captured(fn), first)):
            fail(f"{tag}: two runs and a CUDA-graph replay are not bit-equal")

    # ---- A, anchored shared taps (dcn_3) --------------------------------
    mode = "anchored shared G=1 D=32 (1,4,720,720)"
    x = torch.randn(1, c, *hw, generator=gen).cuda()
    off = field()
    mask = torch.rand(1, 1, *hw, generator=gen).cuda()
    wt = (torch.randn(c, c, 3, 3, generator=gen) * 0.2).cuda()
    b = torch.randn(c, generator=gen).cuda()
    kw = dict(max_displacement=d, shared_taps=True, shared_mask=True)
    g32 = an.dcn_geometry(*hw, c, c, 1, 3, d, bf16=False, shared_taps=True, shared_mask=True)
    g16 = an.dcn_geometry(*hw, c, c, 1, 3, d, bf16=True, shared_taps=True, shared_mask=True)
    beyond(off, g16, f"kernel A {mode}")
    with torch.no_grad():
        got = dcn.deform_conv2d_windowed(x, off, mask, wt, b, anchor=g32, **kw)
        ref = deform_conv2d_windowed_ref(x, off, mask, wt, b, anchor=g32, **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not err <= 1e-4:
            fail(f"kernel A {mode}: f32 max|d| {err} > 1e-4")
        xb = x.to(torch.bfloat16)
        refb = deform_conv2d_windowed_ref(xb.float(), off, mask, wt, b, anchor=g16, **kw)

        def call():
            return dcn.deform_conv2d_windowed(xb, off, mask, wt, b, anchor=g16, **kw)

        gotb = call()
        torch.cuda.synchronize()
        rel = float((gotb.float() - refb).abs().max() / refb.abs().max())
        if not rel <= 2e-2:
            fail(f"kernel A {mode}: bf16 error {rel} of max|ref| > 2e-2")
        same_bits(f"kernel A {mode}", call, gotb)
        clamp = dcn.deform_conv2d_windowed(xb, off, mask, wt, b, **kw)
        moved = float((clamp.float() - gotb.float()).abs().max())
        if not moved > 0.1 * float(refb.abs().max()):
            fail(f"kernel A {mode}: anchored and clamped outputs differ by only {moved}")
        k_ms = measure(call)
        c_ms = measure(lambda: dcn.deform_conv2d_windowed(xb, off, mask, wt, b, **kw))
        p_ms = measure(lambda: deform_conv2d_windowed_ref(xb, off, mask, wt, b, anchor=g16,
                                                          **kw), iters=5)
        # the table in PyTorch ops, what the call's pre-pass does in one launch
        t_ms = measure(lambda: an.anchor_table(off, g16, 1))
    flops = 2 * n_px * c * 9 * c + 9 * n_px * c * 9
    bnd = bound([xb, off, mask, wt, b], [gotb], flops, "bfloat16")
    plan = dcn.tile_plan(1, c, *hw, c, 1, g16.reach, bf16=True, shared_mask=True)
    record("dcn_fwd", mode, 0, err, rel, k_ms, p_ms, None, bnd, calls_anchor=1,
           clamp_ms=c_ms[0], clamp_device_ms=c_ms[1], anchored_vs_clamp_max_abs=moved,
           table_torch_ms=t_ms[0], table_torch_device_ms=t_ms[1],
           bound_fraction=bnd[0] / k_ms[1],
           tile=f"{plan.tile_h}x{plan.tile_w} pad {plan.pad}",
           geometry=f"band {g16.band} xtile {g16.xtile} dl {g16.dl_r:g}/{g16.dl_c:g}",
           digest=digest(got, gotb))

    # ---- B, anchored: the full-resolution grid (band 64) and the s2d one
    # (band 32, the deployment's hr_s2d) ----------------------------------
    import torch.nn.functional as F

    for s2d, calls in ((1, 0), (4, 1)):
        x = torch.randn(1, c, *hw, generator=gen).cuda()
        flow = field()
        g32 = an.warp_geometry(*hw, c, d, bf16=False, s2d=s2d)
        g16 = an.warp_geometry(*hw, c, d, bf16=True, s2d=s2d)
        mode = f"anchored HR D=32 (1,4,720,720) band {g16.band}"
        beyond(an.flow_as_offset(flow), g16, f"kernel B {mode}")
        with torch.no_grad():
            got = warp.flow_warp_windowed(x, flow, d, anchor=g32)
            ref = flow_warp_windowed_ref(x, flow, d, g32)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not err <= 1e-5:
                fail(f"kernel B {mode}: f32 max|d| {err} > 1e-5")
            xb = x.to(torch.bfloat16)
            refb = flow_warp_windowed_ref(xb.float(), flow, d, g16)

            def call():
                return warp.flow_warp_windowed(xb, flow, d, anchor=g16)

            gotb = call()
            torch.cuda.synchronize()
            rel = float((gotb.float() - refb).abs().max() / refb.abs().max())
            if not rel <= 2e-2:
                fail(f"kernel B {mode}: bf16 error {rel} of max|ref| > 2e-2")
            same_bits(f"kernel B {mode}", call, gotb)
            clamp = warp.flow_warp_windowed(xb, flow, d)
            moved = float((clamp.float() - gotb.float()).abs().max())
            if not moved > 0.1 * float(refb.abs().max()):
                fail(f"kernel B {mode}: anchored and clamped outputs differ by only {moved}")
            k_ms = measure(call)
            c_ms = measure(lambda: warp.flow_warp_windowed(xb, flow, d))
            p_ms = measure(lambda: flow_warp_windowed_ref(xb, flow, d, g16), iters=5)
            t_ms = measure(lambda: an.anchor_table(an.flow_as_offset(flow), g16, 1))
            # yardstick: grid_sample at the effective flow, precomputed
            h, w = hw
            from crfp_torch.ops.warp import anchored_flow

            fe = anchored_flow(flow, g16)
            gx = (torch.arange(w, device="cuda").view(1, 1, w) + fe[:, 0]) * (2.0 / (w - 1)) - 1
            gy = (torch.arange(h, device="cuda").view(1, h, 1) + fe[:, 1]) * (2.0 / (h - 1)) - 1
            grid = torch.stack([gx, gy], dim=-1).to(torch.bfloat16)
            lib_ms = measure(lambda: F.grid_sample(xb, grid, mode="bilinear",
                                                   padding_mode="zeros", align_corners=True))
        bnd = bound([xb, flow], [gotb], 8 * n_px * c, "bfloat16")
        record("flow_warp", mode, 0, err, rel, k_ms, p_ms, lib_ms, bnd, calls_anchor=calls,
               clamp_ms=c_ms[0], clamp_device_ms=c_ms[1], anchored_vs_clamp_max_abs=moved,
               table_torch_ms=t_ms[0], table_torch_device_ms=t_ms[1],
               bound_fraction=bnd[0] / k_ms[1],
               geometry=f"band {g16.band} xtile {g16.xtile} dl {g16.dl_r:g}/{g16.dl_c:g}",
               digest=digest(got, gotb))
    return modes


def phase_anchor(gen) -> tuple[list, dict]:
    """Phase 12: anchored HR windows, the JAX package's deployment
    configuration. (a) kernels A and B in anchored mode against their plain
    versions (:func:`_anchor_kernels`); (b) the slice at full width:
    CRFPRuntimeV18 at 1080p / warp 720^2 / mid 32 with bench.py's
    ``_DEPLOY`` flags (windows 8/32, ``hr_s2d``, ``dcn_anchor``) on
    checkpoints/v18_mid32_struct_anchored.npz, 5 frames of a procedural
    clip panning 36 / 44 HR px a frame: in f32 kernels against plain
    versions (>= 80 dB, max|d| <= 1e-3 a frame), in bf16 likewise (>= 85
    dB, max|d| <= 0.02), launch counts asserted (A 4, B 2, C 1 a steady
    frame; of them anchored A 1, B 1); the plain-clamp frames against the
    anchored ones, each outside those limits; tools.bench's anchored
    headline protocol. Returns
    (the records of (a), the launch counts of (b)'s bf16 kernel run)."""
    import torch

    from crfp_torch.bench import card_line
    from crfp_torch.bench.quality_window import panning_clip
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.ops.cuda import dcn, warp
    from crfp_torch.params import from_jax, load_npz, runtime_params_from_batch
    from crfp_torch.tools import bench

    modes = _anchor_kernels(gen)
    t = ANCHOR_FRAMES
    lrs, hrs = (torch.from_numpy(a[:, None]).cuda()
                for a in panning_clip(t, LR_HW, ANCHOR_V, seed=12))
    fvs = hrs[:, :, :FV, :FV].contiguous()
    batch = from_jax(load_npz(str(ANCHOR_CKPT)))

    def build(anchored: bool, dtype):
        cfg = ModelConfig(mid_channels=MID, dcn_window=8, dcn_window_hr=32,
                          hr_s2d=anchored, dcn_anchor=anchored)
        model = CRFPRuntimeV18(cfg, warp_size=WARP, device="cuda", seed=0)
        sd, n_unmapped = runtime_params_from_batch(batch, model.state_dict())
        if n_unmapped != 5:
            fail(f"anchored checkpoint adapter kept {n_unmapped} leaves at init, expected 5")
        model.load_state_dict(sd)
        return model.to(dtype).eval()

    def run(model, dtype):
        outs = []
        with torch.inference_mode():
            for i in range(t):
                lr, fv = lrs[i].to(dtype), fvs[i].to(dtype)
                x_lr, x_hr = model.encode(lr, fv)
                if i == 0:
                    state, out = model.step0(lr, x_lr, x_hr)
                else:
                    state, out = model.step(state, lr, lrs[i - 1].to(dtype), x_lr, x_hr)
                outs.append(out.float())
        torch.cuda.synchronize()
        return outs

    def anchored_counts():
        return {"dcn_fwd": dcn.anchor_launches, "flow_warp": warp.anchor_launches}

    expect = _expect(dcn_fwd=4 * (t - 1), flow_warp=2 * (t - 1), emit=t)
    expect_anchored = {"dcn_fwd": t - 1, "flow_warp": t - 1}
    model = build(True, torch.float32)
    with torch.inference_mode():  # the HR motion the flow net sees on the ROI
        flow = model.compute_flow(lrs[1].permute(0, 3, 1, 2), lrs[0].permute(0, 3, 1, 2))
    hr_flow = flow * 8.0
    print(f"[anchor] clip pans ({8 * ANCHOR_V[0]:g}, {8 * ANCHOR_V[1]:g}) HR px a frame; "
          f"the flow net's HR flow on the ROI: mean (dx, dy) "
          f"({float(hr_flow[:, 0].mean()):.2f}, {float(hr_flow[:, 1].mean()):.2f}), "
          f"max |.| {float(hr_flow.abs().max()):.2f} px")
    lines = {}
    for dtype, db, dmax in ((torch.float32, 80.0, 1e-3),
                            (torch.bfloat16, ANCHOR_BF16_DB, ANCHOR_BF16_DMAX)):
        name = "f32" if dtype == torch.float32 else "bf16"
        model = build(True, dtype)
        with plain_kernels(hr_chains=dtype == torch.float32):
            want = run(model, dtype)
        dcn.anchor_launches = warp.anchor_launches = 0
        _zero_counts()
        t0 = time.perf_counter()
        got = run(model, dtype)
        wall = time.perf_counter() - t0
        launches, anchored = _counts(), anchored_counts()
        print(f"[anchor] {t} frames 1080p warp {WARP} mid {MID} ({ANCHOR_CKPT.name}) {name}, "
              f"_DEPLOY flags (windows 8/32, hr_s2d, dcn_anchor), via kernels in "
              f"{wall:.3f} s (first run, host clock); launches {launches}, anchored {anchored}")
        if launches != expect or anchored != expect_anchored:
            fail(f"anchored slice {name}: launch counts {launches} / anchored {anchored} != "
                 f"expected {expect} / {expect_anchored}")
        _frames_agree(f"[anchor] {name}", got, want, db, dmax, shape=(1, *HR_HW, 3))
        lines[name] = launches
        clamp = run(build(False, dtype), dtype)
        readings = _frames_agree(f"[anchor] {name} anchored vs plain clamp", got[1:],
                                 clamp[1:], -math.inf, None, versus="anchored vs plain-clamp")
        inside = [i + 1 for i, (p, d) in enumerate(readings) if p >= db and d <= dmax]
        if inside:
            fail(f"anchored slice {name}: plain-clamp frames {inside} fall inside the kernels' "
                 f"limit (>= {db:g} dB, max|d| <= {dmax:g}), which then cannot fail kernels "
                 f"that drop the anchor")
    before = _counts()
    line = bench.run(bench.PROTOCOLS[:1])
    got = _since(before)
    *_, reps, warm = bench.PROTOCOLS[0]
    n_reps = warm + 2 * (reps - warm)
    want = _expect(dcn_fwd=16 * n_reps, flow_warp=8 * n_reps, emit=5 * n_reps)
    print(f"[anchor] tools.bench, the anchored _DEPLOY's headline protocol "
          f"({card_line()}); launches {got}")
    print(json.dumps(line))
    if got != want:
        fail(f"tools.bench anchored launch counts {got} != expected {want}")
    return modes, lines["bf16"]


# ---- phase 14: anchored training (ModelConfig.dcn_anchor_vjp) -------------

# phase 14(b): train steps of each kind, their rate, and how fast the noise
# clips move (LR px a frame; up to 40 HR px, past the window D = 32)
ANCHOR_TRAIN_STEPS, ANCHOR_TRAIN_LR, ANCHOR_TRAIN_V = 3, 2e-4, 5.0
# the amp steps' losses, kernels against plain versions, relative: the two
# round to bf16 at other points (A's tensor-core route rounds its modulated
# samples, the plain version its output), and Adam's first, sign-like
# updates carry that into the next steps' losses: 1.1e-3 and 1.3e-3 at step
# 1 of the anchored trunk, 8.1e-4 of the clamped one (NVIDIA H100 80GB HBM3,
# 700 W). The f32 steps hold phase 6's 1e-4. Phase 17 (--drift-only) reads
# where it comes from: with kernel A alone swapped for its plain version the
# drift falls from 1.30e-3 to 7.3e-5 (anchored) and from 8.7e-4 to 6.8e-5
# (clamped); with D, B or F swapped it stays (1.29e-3 to 1.38e-3, 8.65e-4 to
# 8.98e-4; NVIDIA H100 80GB HBM3, 700 W). A rounds where the TPU kernel
# rounds (its modulated samples in bf16, crfp_tpu/ops/pallas/dcn.py:169),
# the plain version computes in f32 and rounds its output: the limit holds
# the plain version's departure from JAX's bf16 rounding, not a fault of
# the kernels.
ANCHOR_TRAIN_AMP_RTOL = 5e-3


def _anchor_train_kernels(gen) -> list:
    """Phase 14(a): kernel D's two anchored modes, dcn_3's shared taps
    (``csrc/dcn_bwd.cu``) and the HR state warp's k = 1
    (``csrc/flow_warp_bwd.cu``), against autograd of their plain versions at
    the training grid (``fullgrad``), at the amp step's (2,4,192,192) and at
    train.sh's (8,4,256,256), on a smooth field whose cell anchors reach
    ±32: f32 to 1e-4 and bf16 (against the f32 plain version) to 2e-2 of
    max|ref| for every gradient; d-offset, d-mask and dW (the warp: d-flow)
    bit-equal over two runs and a CUDA-graph replay on the forward's table;
    d-offset (d-flow) other than the clamped backward's. Device and call ms
    beside the clamped call's, the plain version's and the bytes bound.
    Records carry ``calls_anchor_train``: calls per amp step of phase
    14(b)'s anchored trunk (``hr_s2d``: the warp's s2d grid)."""
    import torch

    from crfp_torch.bench import card_line
    from crfp_torch.bench.train import RECIPE
    from crfp_torch.ops import anchor as an
    from crfp_torch.ops.cuda import dcn, warp
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref
    from crfp_torch.ops.warp import anchored_flow, flow_warp_windowed_ref

    print(f"[anchor train] kernel D's anchored modes on {card_line()}")
    modes = []
    record = functools.partial(_record, modes)
    d, c, b, gt = 32, RECIPE["mid"] // 8, RECIPE["b"], RECIPE["gt"]
    n_rec = RECIPE["t"] - 1
    amp_shape = (f"({b},{c},{gt},{gt})", b, (gt, gt))
    sh_shape = (f"({MAIN_B},{c},{MAIN_GT},{MAIN_GT}) train.sh", MAIN_B, (MAIN_GT, MAIN_GT))

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    def field(n, hw):
        # std 40 px, varying over ~32 px, plus 1 px of noise
        return (_smooth(gen, 2, hw, 40.0, n=n) + rn(n, 2, *hw)).contiguous()

    def beyond(off, geom, what):
        reach = float(an.anchor_table(off, geom, 1).abs().max())
        print(f"[anchor train] {what}: anchors up to {reach:g} px (A = {geom.a_y}/"
              f"{geom.a_x}), |offset| up to {float(off.abs().max()):.1f} px")
        if reach < d:
            fail(f"{what}: no cell's anchor reaches D = {d}")

    def same_bits(tag, fn):
        first = fn()
        if not (torch.equal(fn(), first) and torch.equal(captured(fn), first)):
            fail(f"{tag}: two runs and a CUDA-graph replay are not bit-equal")
        return first

    # ---- D, anchored shared taps (dcn_3) ---------------------------------
    for (label, n, hw), calls in ((amp_shape, n_rec), (sh_shape, 0)):
        mode = f"anchored shared G=1 D=32 {label}"
        x, off = rn(n, c, *hw), field(n, hw)
        mask = torch.rand(n, 1, *hw, generator=gen).cuda()
        wt, bias, gout = rn(c, c, 3, 3, std=0.2), rn(c), rn(n, c, *hw)
        kw = dict(max_displacement=d, shared_taps=True, shared_mask=True)
        geoms = {bf16: an.dcn_geometry(*hw, c, c, 1, 3, d, bf16=bf16, shared_taps=True,
                                       shared_mask=True, fullgrad=True)
                 for bf16 in (False, True)}
        g16 = geoms[True]
        beyond(off, g16, f"kernel D {mode}")

        def kern(*a, g=None):
            return dcn.deform_conv2d_windowed(*a, anchor=g, **kw)

        def plain(*a, g=None):
            return deform_conv2d_windowed_ref(*a, anchor=g, **kw)

        ops = (x, off, mask, wt, bias)
        _, got = _grads(functools.partial(kern, g=geoms[False]), ops, gout)
        _, want = _grads(functools.partial(plain, g=geoms[False]), ops, gout)
        torch.cuda.synchronize()
        err = _check_grads(f"kernel D dcn {mode} f32", got, want, 1e-4)[0]
        xb, gb = x.to(torch.bfloat16), gout.to(torch.bfloat16)
        _, gotb = _grads(functools.partial(kern, g=g16), (xb, *ops[1:]), gb)
        _, wantb = _grads(functools.partial(plain, g=g16), (xb.float(), *ops[1:]), gb.float())
        torch.cuda.synchronize()
        _, rel = _check_grads(f"kernel D dcn {mode} bf16", gotb, wantb, 2e-2)
        _, table = dcn.dcn_forward(xb, off, mask, wt, bias, anchor=g16, with_table=True, **kw)

        def bwd():
            return dcn.dcn_backward(xb, off, mask, wt, gb, anchor=g16, table=table, **kw)

        bits = same_bits(f"kernel D dcn {mode}",
                         lambda: torch.cat([t.flatten() for t in bwd()[1:]]))
        anch, clamp = bwd(), dcn.dcn_backward(xb, off, mask, wt, gb, **kw)
        moved = float((anch[1] - clamp[1]).abs().max())
        if not moved > 0.1 * float(anch[1].abs().max()):
            fail(f"kernel D dcn {mode}: anchored and clamped d-offset differ by only {moved}")
        k_ms = measure(bwd)
        c_ms = measure(lambda: dcn.dcn_backward(xb, off, mask, wt, gb, **kw))
        p_ms = _time_backward(functools.partial(plain, g=g16), (xb, *ops[1:]), gb, iters=5)
        n_px = n * hw[0] * hw[1]
        flops = n_px * 9 * c * (4 * c + 22)  # as phase 5 counts the clamped call
        bnd = bound([xb, off, mask, wt, gb, table], list(anch), flops, "bfloat16")
        plan = dcn.bwd_plan(n, c, *hw, c, 1, g16.reach, shared_taps=True)
        record("dcn_bwd", mode, 0, err, rel, k_ms, p_ms, None, bnd, calls_anchor_train=calls,
               clamp_ms=c_ms[0], clamp_device_ms=c_ms[1], anchored_vs_clamp_max_abs=moved,
               bound_fraction=bnd[0] / k_ms[1],
               tile=f"{plan.tile_h}x{plan.tile_w} pad {plan.pad} grid {plan.grid}"
                    f"{' patch' if plan.patch else ''}",
               geometry=f"band {g16.band} xtile {g16.xtile} dl {g16.dl_r:g}/{g16.dl_c:g}",
               digest=digest(bits))

    # ---- D at k = 1, anchored: the HR state warp on the s2d grid (phase
    # 14(b)'s hr_s2d trunk) and on the full-resolution one (train_procedural
    # and main) ------------------------------------------------------------
    for (label, n, hw), s2d, calls in ((amp_shape, 4, n_rec), (amp_shape, 1, 0),
                                       (sh_shape, 1, 0)):
        x, flow, gout = rn(n, c, *hw), field(n, hw), rn(n, c, *hw)
        geoms = {bf16: an.warp_geometry(*hw, c, d, bf16=bf16, s2d=s2d, fullgrad=True)
                 for bf16 in (False, True)}
        g16 = geoms[True]
        mode = f"anchored HR D=32 {label} band {g16.band}"
        beyond(an.flow_as_offset(flow), g16, f"kernel D warp {mode}")

        def kern(x_, f_, g=None):
            return warp.flow_warp_windowed(x_, f_, d, anchor=g)

        def plain(x_, f_, g=None):
            return flow_warp_windowed_ref(x_, f_, d, g)

        _, got = _grads(functools.partial(kern, g=geoms[False]), (x, flow), gout)
        _, want = _grads(functools.partial(plain, g=geoms[False]), (x, flow), gout)
        torch.cuda.synchronize()
        err = _check_grads(f"kernel D warp {mode} f32", got, want, 1e-4)[0]
        xb, gb = x.to(torch.bfloat16), gout.to(torch.bfloat16)
        _, gotb = _grads(functools.partial(kern, g=g16), (xb, flow), gb)
        _, wantb = _grads(functools.partial(plain, g=g16), (xb.float(), flow), gb.float())
        torch.cuda.synchronize()
        _, rel = _check_grads(f"kernel D warp {mode} bf16", gotb, wantb, 2e-2)
        _, table = warp.flow_warp_forward_table(xb, flow, d, g16)

        def bwd():
            return warp.flow_warp_backward(xb, flow, gb, d, anchor=g16, table=table)

        bits = same_bits(f"kernel D warp {mode}", lambda: bwd()[1])
        anch, clamp = bwd(), warp.flow_warp_backward(xb, flow, gb, d)
        moved = float((anch[1] - clamp[1]).abs().max())
        if not moved > 0.1 * float(anch[1].abs().max()):
            fail(f"kernel D warp {mode}: anchored and clamped d-flow differ by only {moved}")
        k_ms = measure(bwd)
        c_ms = measure(lambda: warp.flow_warp_backward(xb, flow, gb, d))
        p_ms = _time_backward(functools.partial(plain, g=g16), (xb, flow), gb, iters=5)
        # yardstick: grid_sample's backward at the effective flow (a bf16
        # grid computed beforehand, as phase 5's for the clamped call)
        h, w = hw
        fe = anchored_flow(flow, g16)
        gx = (torch.arange(w, device="cuda").view(1, 1, w) + fe[:, 0]) * (2.0 / (w - 1)) - 1
        gy = (torch.arange(h, device="cuda").view(1, h, 1) + fe[:, 1]) * (2.0 / (h - 1)) - 1
        grid = torch.stack([gx, gy], dim=-1).to(torch.bfloat16)
        lib_ms = measure(lambda: torch.ops.aten.grid_sampler_2d_backward(
            gb, xb, grid, 0, 0, True, [True, True]))
        bnd = bound([xb, flow, gb, table], list(anch), 20 * n * h * w * c, "bfloat16")
        record("flow_warp_bwd", mode, 0, err, rel, k_ms, p_ms, lib_ms, bnd,
               calls_anchor_train=calls, clamp_ms=c_ms[0], clamp_device_ms=c_ms[1],
               anchored_vs_clamp_max_abs=moved, bound_fraction=bnd[0] / k_ms[1],
               geometry=f"band {g16.band} xtile {g16.xtile} dl {g16.dl_r:g}/{g16.dl_c:g}",
               digest=digest(bits))
    return modes


def _anchor_train_expect(steps: int, n_rec: int) -> dict:
    """Anchored-mode launches of ``steps`` anchored train steps of ``n_rec``
    recurrent steps each: dcn_3 (A) and the HR state warp (B) twice a
    recurrent step (remat recomputes it), D once each."""
    return {"dcn_fwd": 2 * n_rec * steps, "flow_warp": 2 * n_rec * steps,
            "dcn_bwd": n_rec * steps, "flow_warp_bwd": n_rec * steps}


def phase_anchor_train(gen, data: str, tmp: Path) -> tuple[list, dict, dict]:
    """Phase 14: anchored training, the JAX package's deployment
    configuration trained as it is deployed (``dcn_anchor_vjp``). (a)
    kernel D's anchored modes (:func:`_anchor_train_kernels`); (b) CRFP v18
    mid 32, windows 8/32, ``hr_s2d``, ``dcn_anchor`` + ``dcn_anchor_vjp``
    from checkpoints/v18_mid32_struct_anchored.npz at the recipe (B 2, T 7,
    GT 192) on noise clips moving up to 40 HR px a frame: 3 f32 and 3 amp
    steps through the kernels against the same steps through the plain
    versions (losses to 1e-4 relative, every parameter to 2*lr*steps, as
    phase 6), launches asserted (of them A, B and D in anchored mode), then
    ms a step of the anchored amp step beside the clamped one (clamped,
    anchored, anchored, clamped; and the full-resolution grid); (c) python -m
    crfp_torch.main with train.sh's flags and --dcn_anchor true (windows
    8/32, which anchoring needs) on phase 9's tree at ``data``: its steps'
    launches asserted, its log naming the anchored training grid. Returns
    (the records of (a), the launch counts of (b)'s amp kernel steps, their
    anchored-mode part)."""
    from crfp_torch import main as cli
    from crfp_torch.bench import card_line
    from crfp_torch.bench.train import RECIPE, device_batches, run_train_bench

    modes = _anchor_train_kernels(gen)
    steps, lr, n_rec = ANCHOR_TRAIN_STEPS, ANCHOR_TRAIN_LR, RECIPE["t"] - 1
    batches = device_batches(steps, seed=14, v_max=ANCHOR_TRAIN_V)
    build = dict(ckpt=str(ANCHOR_CKPT), anchor=True, hr_s2d=True)
    expect, expect_anchored = _train_expect(steps), _anchor_train_expect(steps, n_rec)
    _train_vs_plain("[anchor train]", steps, lr, expect, batches,
                    expect_anchored=expect_anchored, **build)
    # the clamped trunk's amp steps under the same comparison, read beside
    # the anchored ones (not held: a reference for the amp limit)
    _train_vs_plain("[anchor train] clamped reference", steps, lr, expect, batches, amp=True,
                    loss_rtol=None, ckpt=str(ANCHOR_CKPT))
    launches = _train_vs_plain("[anchor train]", steps, lr, expect, batches, amp=True,
                               expect_anchored=expect_anchored,
                               loss_rtol=ANCHOR_TRAIN_AMP_RTOL, **build)
    anchored = _anchor_counts()

    # ms a step, anchored beside clamped, in turns
    readings = []
    for anchor, s2d in ((False, False), (True, True), (True, True), (False, False),
                        (True, False)):
        res = run_train_bench(anchor=anchor, hr_s2d=s2d)
        readings.append(res)
        print(f"[anchor train] amp step at the recipe, "
              f"{'anchored ' + ('s2d grid' if s2d else 'full grid') if anchor else 'clamped'}"
              f": {res['ms_per_step']:.2f} ms ({res['frames_per_s']:.1f} frames/s, peak "
              f"{res['peak_mib']:.0f} MiB, CUDA events; {card_line()})")
        if not math.isfinite(res["last_loss"]):
            fail(f"anchored train bench: loss {res['last_loss']}")
    print(f"[anchor train] {json.dumps(readings)}")

    # (c) the entry point with train.sh's flags and --dcn_anchor true
    run = tmp / "train_anchor"
    argv = TRAIN_SH + ["--save_dir", str(run), "--dataset_dir", data,
                       "--frame_cache", str(tmp / "cache"), "--dcn_anchor", "true",
                       "--dcn_window", "8", "--dcn_window_hr", "32", "--val_every", "999999",
                       "--viz_every", "0", "--save_every", "999999"]
    _zero_counts()
    t0 = time.perf_counter()
    out = cli.main(argv)
    wall = time.perf_counter() - t0
    got, got_anchored = _counts(), _anchor_counts()
    n_steps = out["step"]
    losses = [m["loss"] for m in out["metrics"]]
    print(f"[anchor train] main, train.sh's flags + --dcn_anchor true (windows 8/32): "
          f"{n_steps} steps in {wall:.2f} s (host clock; {card_line()}); losses {losses}; "
          f"launches {got}, anchored {got_anchored}")
    log = (run / "train.log").read_text()
    line = next((ln for ln in log.splitlines() if "--dcn_anchor: anchored HR windows" in ln),
                None)
    print(f"[anchor train] main's log: {line}")
    if line is None or "the training grid (dcn_anchor_vjp)" not in line:
        fail("main --dcn_anchor true: the log does not name the anchored training grid")
    if not (n_steps >= 1 and all(math.isfinite(v) for v in losses)):
        fail(f"main --dcn_anchor true: {n_steps} steps, losses {losses}")
    want = _main_expect(train_steps=n_steps)
    if got != want or got_anchored != _anchor_train_expect(n_steps, MAIN_T - 1):
        fail(f"main --dcn_anchor true: launch counts {got} / anchored {got_anchored} != "
             f"expected {want} / {_anchor_train_expect(n_steps, MAIN_T - 1)}")
    return modes, launches, anchored


# ---- phase 15: every DCN width the JAX kernels take (the general route) ----
# (a)'s widths: (id, C, O, G, kh = kw, shared, A's plane, calls per unit of
# each general entry's main path). A and E run at the serving slice's
# planes, per-tap at 1/4 resolution (1,C,180,180) and (E, the gate's)
# (1,C,180,320) at D = 8, shared taps at the HR (1,C,720,720) at D = 32; D
# at the amp step's (2,C,48,48) and (2,C,192,192). The units: a steady
# frame of the mid-24 serving slice (A: 3 per-tap + 1 dcn_3), a mid-24
# amp step (D: 18 per-tap, 6 dcn_3), a DEPLOY frame of the mid-24 gate (E:
# 3). The tuned widths of mid 32 come last: there the general route, named
# by plan=, is also held against the tuned one. The last field: A's calls
# at the amp step's planes in a mid-24 amp step (36 per-tap (2,24,48,48),
# 12 dcn_3 (2,3,192,192)), timed beside the serving planes.
WIDTHS = [
    ("mid8 per-tap", 8, 8, 8, 3, False, None, (0, 0, 0), 0),
    ("mid8 dcn_3", 1, 1, 1, 3, True, None, (0, 0, 0), 0),
    ("mid24 per-tap", 24, 24, 8, 3, False, None, (3, 18, 3), 36),
    ("mid24 dcn_3", 3, 3, 1, 3, True, None, (1, 6, 0), 12),
    ("mid48 per-tap", 48, 48, 8, 3, False, None, (0, 0, 0), 0),
    ("mid48 dcn_3", 6, 6, 1, 3, True, None, (0, 0, 0), 0),
    ("mid64 per-tap", 64, 64, 8, 3, False, None, (0, 0, 0), 0),
    ("mid64 dcn_3", 8, 8, 1, 3, True, None, (0, 0, 0), 0),
    ("dg1 mid32", 32, 32, 1, 3, False, None, (0, 0, 0), 0),
    ("dg2 mid32", 32, 32, 2, 3, False, None, (0, 0, 0), 0),
    ("dg4 mid32", 32, 32, 4, 3, False, None, (0, 0, 0), 0),
    ("dg16 mid32", 32, 32, 16, 3, False, None, (0, 0, 0), 0),
    ("k1 mid32", 32, 32, 8, 1, False, None, (0, 0, 0), 0),
    ("k5 mid32", 32, 32, 8, 5, False, None, (0, 0, 0), 0),
    ("k5 mid32 dcn_3", 4, 4, 1, 5, True, None, (0, 0, 0), 0),
    # the gen-1 X8 at mid 16, dg 16: its levels' 16 and 1 groups
    ("pyramid mid16 dg16 lv1", 16, 16, 16, 3, False, (180, 320), (0, 0, 0), 0),
    ("pyramid mid16 dg16 lv3", 16, 16, 1, 3, False, (180, 320), (0, 0, 0), 0),
    ("mid32 per-tap", 32, 32, 8, 3, False, None, (0, 0, 0), 0),
    ("mid32 dcn_3", 4, 4, 1, 3, True, None, (0, 0, 0), 0),
]
# the widths whose general A and E are also timed with f32 x (train.sh's
# f32 recipe runs mid 24's; O > 8 takes the chunked branch in f32), and
# those whose D is also run on its chunked branch (the rule picks the pixel
# one there; the chunked one takes the widths whose pixel branch does not fit)
WIDTHS_F32_TIMED = ("mid24 per-tap", "mid24 dcn_3", "mid48 per-tap", "dg16 mid32")
WIDTHS_D_CHUNKED = ("mid24 per-tap", "mid24 dcn_3")
WIDTH_FRAMES = 5  # the serving slice's t
# phase 15(b)'s runtime slices in bf16 on seeded weights, kernels against
# plain versions, a frame: between the sound readings (>= 73.97 dB, max|d|
# <= 7.8e-3: the output's bf16 rounding sets them) and the planted faults'
# (the mask 2 % low <= 70.66 dB, the anchored slice served with the plain
# clamp <= 60.13; NVIDIA H100 80GB HBM3, 700 W). max|d| tells neither fault
# from the sound frames. A fault below ~2 % of the DCN's output passes.
WIDTHS_BF16_DB, WIDTHS_BF16_DMAX = 72.0, 0.02
PLANTED_FAULT = "kernel A's mask read 2 % low"
# the widths' trunks in (b): (tag, mid, dg, dcn_kernel)
WIDTH_TRUNKS = [("mid24", 24, 8, 3), ("mid64", 64, 8, 3), ("dg16", 32, 16, 3), ("k5", 32, 8, 5)]


def _width_kernels(gen) -> list:
    """Phase 15(a): the general route of kernels A, D and E, named by
    ``plan=`` at every width of :data:`WIDTHS` (the rule's own route
    printed beside it), against their plain versions: f32 to phase 2's
    limits (A 1e-4 abs, clamped and unclamped; D and E 1e-4 of max|ref|),
    bf16 to 2e-2 of max|ref| of the f32 plain version on the same values;
    A and E bit-equal over two runs and from a CUDA graph, D's d-offset,
    d-mask and dW over two runs; at mid 32 the general route against the
    tuned one; D's chunked branch forced at :data:`WIDTHS_D_CHUNKED` under
    the same checks. Device and call ms in bf16 beside the plain version's
    call ms and the bound (bytes at 3.35 TB/s against the operations at the
    bf16 peak, as phases 2 and 5 count them); A and E also with f32 x at
    :data:`WIDTHS_F32_TIMED` (the f32 peak). Returns the records."""
    import torch

    from crfp_torch.bench import card_line
    from crfp_torch.ops.cuda import dcn, dcn_fused
    from crfp_torch.ops.dcn_windowed import (
        deform_conv2d_fusedprep_ref,
        deform_conv2d_windowed_ref,
    )

    modes = []
    record = functools.partial(_record, modes)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    def rel_err(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    def plain_ms(fn):  # the plain versions are slow: a short loop, call time only
        return time_ms(fn, iters=3, warmup=1), None

    for wid, c, o, g, k, shared, plane, (a_calls, d_calls, e_calls), step_calls in WIDTHS:
        taps, k2 = (1 if shared else k * k), k * k
        hw = WARP if shared else (plane or (WARP[0] // 4, WARP[1] // 4))
        d = 32 if shared else 8
        tag = f"{wid} C{c} O{o} G{g} {k}x{k}"
        kw = dict(max_displacement=d, shared_taps=shared, shared_mask=shared)
        routes = {name: dcn.width_route(name, c, o, g, k, k, shared=shared)
                  for name in ("dcn_fwd", "dcn_bwd") + (() if shared else ("dcn_fused",))}

        def fwd_plan(x_, d_, kernel="dcn_fwd"):
            return dcn.tile_plan(*x_.shape, o, g, d_, bf16=x_.dtype == bf, shared_mask=shared,
                                 shared_taps=shared, kh=k, kw=k, kernel=kernel,
                                 route="general")

        # ---- A ----------------------------------------------------------
        x = randn(1, c, *hw)
        off = (_smooth(gen, 2, hw, d).repeat(1, g * taps, 1, 1)
               + randn(1, g * taps * 2, *hw, std=1.0 if shared else 2.0))
        mask = torch.rand(1, g * taps, *hw, generator=gen).cuda()
        wt, b = randn(o, c, k, k, std=0.1), randn(o)
        err = 0.0
        before = dcn.general_launches
        for d_ in (d, None):
            kw_ = dict(kw, max_displacement=d_)
            got = dcn.dcn_forward(x, off, mask, wt, b, plan=fwd_plan(x, d_), **kw_)
            ref = deform_conv2d_windowed_ref(x, off, mask, wt, b, **kw_)
            torch.cuda.synchronize()
            err = max(err, float((got - ref).abs().max()))
        ref = deform_conv2d_windowed_ref(x, off, mask, wt, b, **kw)
        xb = x.to(bf)
        pb = fwd_plan(xb, d)
        gotb = dcn.dcn_forward(xb, off, mask, wt, b, plan=pb, **kw)
        torch.cuda.synchronize()
        rel = rel_err(gotb, ref)
        if dcn.general_launches != before + 3:
            fail(f"[widths] A {tag}: {dcn.general_launches - before} general launches, not 3")
        if not (err <= 1e-4 and rel <= 2e-2):
            fail(f"[widths] A {tag}: f32 max|d| {err} (limit 1e-4), bf16 {rel} of max|ref| "
                 f"(limit 2e-2)")
        if not torch.equal(dcn.dcn_forward(xb, off, mask, wt, b, plan=pb, **kw), gotb) or \
                not torch.equal(captured(lambda: dcn.dcn_forward(xb, off, mask, wt, b, plan=pb,
                                                                 **kw)), gotb):
            fail(f"[widths] A {tag}: two runs, or a CUDA-graph replay, differ")
        extra = {}
        if routes["dcn_fwd"] == "tuned":  # the tuned route on the same operands
            extra["vs_tuned_f32"] = rel_err(
                dcn.dcn_forward(x, off, mask, wt, b, plan=fwd_plan(x, d), **kw),
                dcn.dcn_forward(x, off, mask, wt, b, **kw))
            extra["vs_tuned_bf16"] = rel_err(gotb, dcn.dcn_forward(xb, off, mask, wt, b, **kw))
            extra["tuned_ms"] = measure(lambda: dcn.dcn_forward(xb, off, mask, wt, b, **kw))
            if not (extra["vs_tuned_f32"] <= 1e-5 and extra["vs_tuned_bf16"] <= 1e-2):
                fail(f"[widths] A {tag}: general against tuned {extra}")
        n_px = hw[0] * hw[1]
        bnd = bound([xb, off, mask, wt, b], [gotb], 2 * n_px * c * k2 * o + 9 * n_px * c * k2,
                    "bfloat16")
        k_ms = measure(lambda: dcn.dcn_forward(xb, off, mask, wt, b, plan=pb, **kw))
        if "tuned_ms" in extra:
            extra["general_over_tuned"] = k_ms[1] / extra["tuned_ms"][1]
        record("dcn_fwd_general", f"{tag} (1,{c},{hw[0]},{hw[1]}) D={d}", a_calls, err, rel,
               k_ms, plain_ms(lambda: deform_conv2d_windowed_ref(xb, off, mask, wt, b, **kw)),
               None, bnd, route=routes["dcn_fwd"], branch=pb.branch,
               bound_fraction=bnd[0] / k_ms[1], digest=digest(got, gotb), **extra)
        if wid in WIDTHS_F32_TIMED:  # the same call with f32 x (err: its check above)
            pf = fwd_plan(x, d)
            fbnd = bound([x, off, mask, wt, b], [got],
                         2 * n_px * c * k2 * o + 9 * n_px * c * k2, "float32")
            f_ms = measure(lambda: dcn.dcn_forward(x, off, mask, wt, b, plan=pf, **kw))
            record("dcn_fwd_general", f"{tag} f32 (1,{c},{hw[0]},{hw[1]}) D={d}", 0, err,
                   None, f_ms, plain_ms(lambda: deform_conv2d_windowed_ref(x, off, mask, wt, b,
                                                                           **kw)),
                   None, fbnd, route=routes["dcn_fwd"], branch=pf.branch,
                   bound_fraction=fbnd[0] / f_ms[1])
        if step_calls:  # A at the amp step's planes (2,C,48,48) / (2,C,192,192)
            sx = randn(2, c, *(192, 192) if shared else (48, 48))
            shw = sx.shape[2:]
            soff = (_smooth(gen, 2, shw, d, n=2).repeat(1, g * taps, 1, 1)
                    + randn(2, g * taps * 2, *shw, std=1.0 if shared else 2.0))
            smask = torch.rand(2, g * taps, *shw, generator=gen).cuda()
            sxb = sx.to(bf)
            spb = fwd_plan(sxb, d)
            sgot = dcn.dcn_forward(sxb, soff, smask, wt, b, plan=spb, **kw)
            sref = deform_conv2d_windowed_ref(sx, soff, smask, wt, b, **kw)
            serr = float((dcn.dcn_forward(sx, soff, smask, wt, b, plan=fwd_plan(sx, d), **kw)
                          - sref).abs().max())
            torch.cuda.synchronize()
            srel = rel_err(sgot, sref)
            if not (serr <= 1e-4 and srel <= 2e-2):
                fail(f"[widths] A {tag} at the amp step's planes: f32 max|d| {serr} (limit "
                     f"1e-4), bf16 {srel} of max|ref| (limit 2e-2)")
            n_px = 2 * shw[0] * shw[1]
            sbnd = bound([sxb, soff, smask, wt, b], [sgot],
                         2 * n_px * c * k2 * o + 9 * n_px * c * k2, "bfloat16")
            s_ms = measure(lambda: dcn.dcn_forward(sxb, soff, smask, wt, b, plan=spb, **kw))
            # calls 0: not a serving frame's; step_calls a mid-24 amp step's
            record("dcn_fwd_general", f"{tag} amp step (2,{c},{shw[0]},{shw[1]}) D={d}", 0,
                   serr, srel, s_ms, plain_ms(lambda: deform_conv2d_windowed_ref(
                       sxb, soff, smask, wt, b, **kw)), None, sbnd, route=routes["dcn_fwd"],
                   branch=spb.branch, bound_fraction=sbnd[0] / s_ms[1], step_calls=step_calls)

        # ---- D, at the amp step's planes ---------------------------------
        thw = (192, 192) if shared else (48, 48)
        tn = 2
        x = randn(tn, c, *thw)
        off = (_smooth(gen, 2, thw, d, n=tn).repeat(1, g * taps, 1, 1)
               + randn(tn, g * taps * 2, *thw, std=1.0 if shared else 2.0))
        mask = torch.rand(tn, g * taps, *thw, generator=gen).cuda()
        wt, gout = randn(o, c, k, k, std=0.1), randn(tn, o, *thw)
        bplan = dcn.bwd_plan(tn, c, *thw, o, g, d, shared_taps=shared, shared_mask=shared,
                             kh=k, kw=k, route="general")
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, off, mask, wt)]
        deform_conv2d_windowed_ref(*leaves, None, **kw).backward(gout)
        want = [t.grad for t in leaves]
        before = dcn.bwd_general_launches
        got = dcn.dcn_backward(x, off, mask, wt, gout, plan=bplan, **kw)
        err = max(rel_err(a_, w_) for a_, w_ in zip(got, want))
        xb, gb = x.to(bf), gout.to(bf)
        leaves = [t.detach().float().clone().requires_grad_(True) for t in (xb, off, mask, wt)]
        deform_conv2d_windowed_ref(*leaves, None, **kw).backward(gb.float())
        gotb = dcn.dcn_backward(xb, off, mask, wt, gb, plan=bplan, **kw)
        again = dcn.dcn_backward(xb, off, mask, wt, gb, plan=bplan, **kw)
        torch.cuda.synchronize()
        rel = max(rel_err(a_, l_.grad) for a_, l_ in zip(gotb, leaves))
        if dcn.bwd_general_launches != before + 3:
            fail(f"[widths] D {tag}: {dcn.bwd_general_launches - before} general launches")
        if not (err <= 1e-4 and rel <= 2e-2):
            fail(f"[widths] D {tag}: f32 {err} of max|ref| (limit 1e-4), bf16 {rel} (2e-2)")
        if not all(torch.equal(a_, b_) for a_, b_ in zip(gotb[1:], again[1:])):
            fail(f"[widths] D {tag}: d-offset, d-mask or dW differ over two runs")
        extra = {}
        if routes["dcn_bwd"] == "tuned":
            tuned = dcn.dcn_backward(x, off, mask, wt, gout, **kw)
            extra["vs_tuned_f32"] = max(rel_err(a_, b_) for a_, b_ in zip(got, tuned))
            extra["tuned_ms"] = measure(lambda: dcn.dcn_backward(xb, off, mask, wt, gb, **kw))
            if not extra["vs_tuned_f32"] <= 1e-4:
                fail(f"[widths] D {tag}: general against tuned {extra}")
        n_px = tn * thw[0] * thw[1]
        bnd = bound([xb, off, mask, wt, gb], list(gotb), n_px * k2 * c * (4 * o + 22),
                    "bfloat16")
        k_ms = measure(lambda: dcn.dcn_backward(xb, off, mask, wt, gb, plan=bplan, **kw))
        if "tuned_ms" in extra:
            extra["general_over_tuned"] = k_ms[1] / extra["tuned_ms"][1]

        def plain_bwd():
            lv = [t.detach().requires_grad_(True) for t in (xb, off, mask, wt)]
            deform_conv2d_windowed_ref(*lv, None, **kw).backward(gb)

        p_ms = plain_ms(plain_bwd)
        record("dcn_bwd_general", f"{tag} ({tn},{c},{thw[0]},{thw[1]}) D={d}", d_calls, err,
               rel, k_ms, p_ms, None, bnd, route=routes["dcn_bwd"],
               branch=bplan.branch, bound_fraction=bnd[0] / k_ms[1],
               digest=digest(*gotb[1:]), **extra)
        if wid in WIDTHS_D_CHUNKED:  # D's chunked branch on the same operands and limits
            cplan = dcn.bwd_plan(tn, c, *thw, o, g, d, shared_taps=shared, shared_mask=shared,
                                 kh=k, kw=k, route="general", branch="chunked")
            before = dcn.bwd_general_launches
            cerr = max(rel_err(a_, w_) for a_, w_ in zip(
                dcn.dcn_backward(x, off, mask, wt, gout, plan=cplan, **kw), want))
            cgotb = dcn.dcn_backward(xb, off, mask, wt, gb, plan=cplan, **kw)
            cagain = dcn.dcn_backward(xb, off, mask, wt, gb, plan=cplan, **kw)
            torch.cuda.synchronize()
            crel = max(rel_err(a_, l_.grad) for a_, l_ in zip(cgotb, leaves))
            if dcn.bwd_general_launches != before + 3:
                fail(f"[widths] D {tag} (general/chunked): "
                     f"{dcn.bwd_general_launches - before} general launches, not 3")
            if not (cerr <= 1e-4 and crel <= 2e-2):
                fail(f"[widths] D {tag} (general/chunked): f32 {cerr} of max|ref| (limit "
                     f"1e-4), bf16 {crel} (2e-2)")
            if not all(torch.equal(a_, b_) for a_, b_ in zip(cgotb[1:], cagain[1:])):
                fail(f"[widths] D {tag} (general/chunked): d-offset, d-mask or dW differ over "
                     f"two runs")
            c_ms = measure(lambda: dcn.dcn_backward(xb, off, mask, wt, gb, plan=cplan, **kw))
            record("dcn_bwd_general", f"{tag} chunked ({tn},{c},{thw[0]},{thw[1]}) D={d}", 0,
                   cerr, crel, c_ms, p_ms, None, bnd, route=routes["dcn_bwd"],
                   branch=cplan.branch, bound_fraction=bnd[0] / c_ms[1],
                   digest=digest(*cgotb[1:]))

        # ---- E, per-tap, at the gate's 1/4-res plane ---------------------
        if shared:
            continue
        ghw = plane or (GATE_LR_HW[0] * 2, GATE_LR_HW[1] * 2)
        x = randn(1, c, *ghw)
        raw = _smooth(gen, g * k2 * 2, ghw, 0.3) + randn(1, g * k2 * 2, *ghw, std=0.02)
        rawm = _smooth(gen, g * k2, ghw, 1.5)
        flow = _smooth(gen, 2, ghw, 3.0)
        wt, b = randn(o, c, k, k, std=0.1), randn(o)
        ekw = dict(max_residue_magnitude=10.0, max_displacement=8)
        before = dcn_fused.general_launches
        ep = fwd_plan(x, 8, "dcn_fused")
        got = dcn_fused.deform_conv2d_fusedprep(x, raw, rawm, flow, wt, b, plan=ep, **ekw)
        ref = deform_conv2d_fusedprep_ref(x, raw, rawm, flow, wt, b, **ekw)
        xb, rb, rmb = x.to(bf), raw.to(bf), rawm.to(bf)
        epb = fwd_plan(xb, 8, "dcn_fused")
        gotb = dcn_fused.deform_conv2d_fusedprep(xb, rb, rmb, flow, wt, b, plan=epb, **ekw)
        refb = deform_conv2d_fusedprep_ref(xb.float(), rb.float(), rmb.float(), flow, wt, b,
                                           **ekw)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref), rel_err(gotb, refb)
        if dcn_fused.general_launches != before + 2:
            fail(f"[widths] E {tag}: {dcn_fused.general_launches - before} general launches")
        if not (err <= 1e-4 and rel <= 2e-2):
            fail(f"[widths] E {tag}: f32 {err} of max|ref| (limit 1e-4), bf16 {rel} (2e-2)")
        if not torch.equal(captured(lambda: dcn_fused.deform_conv2d_fusedprep(
                xb, rb, rmb, flow, wt, b, plan=epb, **ekw)), gotb):
            fail(f"[widths] E {tag}: replayed from a CUDA graph it differs")
        extra = {}
        if routes["dcn_fused"] == "tuned":
            extra["vs_tuned_bf16"] = rel_err(gotb, dcn_fused.deform_conv2d_fusedprep(
                xb, rb, rmb, flow, wt, b, **ekw))
            extra["tuned_ms"] = measure(lambda: dcn_fused.deform_conv2d_fusedprep(
                xb, rb, rmb, flow, wt, b, **ekw))
            if not extra["vs_tuned_bf16"] <= 1e-2:
                fail(f"[widths] E {tag}: general against tuned {extra}")
        n_px = ghw[0] * ghw[1]
        bnd = bound([xb, rb, rmb, flow, wt, b], [gotb],
                    2 * n_px * c * k2 * o + 9 * n_px * c * k2, "bfloat16")
        k_ms = measure(lambda: dcn_fused.deform_conv2d_fusedprep(xb, rb, rmb, flow, wt, b,
                                                                  plan=epb, **ekw))
        if "tuned_ms" in extra:
            extra["general_over_tuned"] = k_ms[1] / extra["tuned_ms"][1]
        record("dcn_fused_general", f"{tag} (1,{c},{ghw[0]},{ghw[1]}) D=8", e_calls, err, rel,
               k_ms, plain_ms(lambda: deform_conv2d_fusedprep_ref(xb, rb, rmb, flow, wt, b,
                                                                  **ekw)),
               None, bnd, route=routes["dcn_fused"], branch=epb.branch,
               bound_fraction=bnd[0] / k_ms[1], digest=digest(got, gotb), **extra)
        if wid in WIDTHS_F32_TIMED:  # the same call with f32 x (err: its check above)
            fbnd = bound([x, raw, rawm, flow, wt, b], [got],
                         2 * n_px * c * k2 * o + 9 * n_px * c * k2, "float32")
            f_ms = measure(lambda: dcn_fused.deform_conv2d_fusedprep(x, raw, rawm, flow, wt, b,
                                                                      plan=ep, **ekw))
            record("dcn_fused_general", f"{tag} f32 (1,{c},{ghw[0]},{ghw[1]}) D=8", 0, err,
                   None, f_ms, plain_ms(lambda: deform_conv2d_fusedprep_ref(
                       x, raw, rawm, flow, wt, b, **ekw)),
                   None, fbnd, route=routes["dcn_fused"], branch=ep.branch,
                   bound_fraction=fbnd[0] / f_ms[1])
    # the general route against the tuned one at mid 32 (plan= names it),
    # device ms a call; and A's general route per amp step at mid 24
    for m in modes:
        if "general_over_tuned" in m:
            print(f"[widths] general/tuned {m['kernel']} {m['mode']} ({m['branch']}): "
                  f"{m['device_ms']:.4f} / {m['tuned_ms'][1]:.4f} ms = "
                  f"{m['general_over_tuned']:.2f}x ({card_line()})")
    step = [m for m in modes if m.get("step_calls")]
    print(f"[widths] A general at the mid-24 amp step's planes: "
          f"{sum(m['device_ms'] * m['step_calls'] for m in step):.4f} ms of device a step ("
          + ", ".join(f"{m['step_calls']} x {m['device_ms']:.4f} {m['branch']}" for m in step)
          + f"; bound {sum(m['bound_ms'] * m['step_calls'] for m in step):.4f}; "
          f"{card_line()})")
    modes += _width_anchored_kernels(gen)
    return modes


def _width_anchored_kernels(gen) -> list:
    """Phase 15(a), anchored: dcn_3's anchored shared taps on the general
    route at mid 24 (C = O = 3) and mid 64 (C = O = 8), A forward at the
    serving plane (1,C,720,720) and D backward at the amp step's
    (2,C,192,192) on the training grid (``fullgrad``), on a smooth field
    whose cell anchors reach past D = 32: against their plain versions
    (autograd of them for D) at phases 12(a) and 14(a)'s limits (A f32 1e-4
    abs, D f32 1e-4 of max|ref| per gradient, bf16 2e-2 of max|ref|), two
    runs and a CUDA-graph replay bit-equal, the output (D: d-offset) other
    than the clamped call's, each launch on the general route and anchored.
    Returns the records (0 calls a unit: the units are unanchored)."""
    import torch

    from crfp_torch.ops import anchor as an
    from crfp_torch.ops.cuda import dcn
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    modes = []
    record = functools.partial(_record, modes)
    d = 32
    kw = dict(max_displacement=d, shared_taps=True, shared_mask=True)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    def beyond(off, geom, what):
        reach = float(an.anchor_table(off, geom, 1).abs().max())
        print(f"[widths] {what}: anchors up to {reach:g} px (A = {geom.a_y}/{geom.a_x}), "
              f"|offset| up to {float(off.abs().max()):.1f} px")
        if reach < d:
            fail(f"[widths] {what}: no cell's anchor reaches D = {d}")

    def same_bits(tag, fn):
        first = fn()
        if not (torch.equal(fn(), first) and torch.equal(captured(fn), first)):
            fail(f"[widths] {tag}: two runs and a CUDA-graph replay are not bit-equal")
        return first

    def now():
        return (dcn.general_launches, dcn.anchor_launches, dcn.bwd_general_launches,
                dcn.bwd_anchor_launches)

    def counted(tag, before, fwd, bwd):
        got = tuple(a - b for a, b in zip(now(), before))
        if got != (fwd, fwd, bwd, bwd):
            fail(f"[widths] {tag}: general / anchored launches of A, D {got}, expected "
                 f"{(fwd, fwd, bwd, bwd)}")

    for mid in (24, 64):
        c = mid // 8
        if dcn.width_route("dcn_fwd", c, c, 1, 3, 3, shared=True, bf16=True) != "general" or \
                dcn.width_route("dcn_bwd", c, c, 1, 3, 3, shared=True) != "general":
            fail(f"[widths] mid {mid} dcn_3: not on the general route")

        # ---- A, anchored shared taps, at the serving plane ----------------
        hw = WARP
        mode = f"anchored mid{mid} dcn_3 C{c} O{c} G1 3x3 (1,{c},{hw[0]},{hw[1]}) D={d}"
        x = rn(1, c, *hw)
        off = (_smooth(gen, 2, hw, 40.0) + rn(1, 2, *hw)).contiguous()
        mask = torch.rand(1, 1, *hw, generator=gen).cuda()
        wt, b = rn(c, c, 3, 3, std=0.2), rn(c)
        g32, g16 = (an.dcn_geometry(*hw, c, c, 1, 3, d, bf16=bf16, shared_taps=True,
                                    shared_mask=True) for bf16 in (False, True))
        beyond(off, g16, f"A {mode}")
        before = now()
        with torch.no_grad():
            got = dcn.dcn_forward(x, off, mask, wt, b, anchor=g32, **kw)
            ref = deform_conv2d_windowed_ref(x, off, mask, wt, b, anchor=g32, **kw)
            xb = x.to(torch.bfloat16)
            refb = deform_conv2d_windowed_ref(xb.float(), off, mask, wt, b, anchor=g16, **kw)
            gotb = dcn.dcn_forward(xb, off, mask, wt, b, anchor=g16, **kw)
            torch.cuda.synchronize()
            counted(f"A {mode}", before, 2, 0)
            err = float((got - ref).abs().max())
            rel = float((gotb.float() - refb).abs().max() / refb.abs().max())
            if not (err <= 1e-4 and rel <= 2e-2):
                fail(f"[widths] A {mode}: f32 max|d| {err} (limit 1e-4), bf16 {rel} of "
                     f"max|ref| (limit 2e-2)")

            def call():
                return dcn.dcn_forward(xb, off, mask, wt, b, anchor=g16, **kw)

            same_bits(f"A {mode}", call)
            moved = float((dcn.dcn_forward(xb, off, mask, wt, b, **kw).float()
                           - gotb.float()).abs().max())
            if not moved > 0.1 * float(refb.abs().max()):
                fail(f"[widths] A {mode}: anchored and clamped outputs differ by only {moved}")
            k_ms = measure(call)
            c_ms = measure(lambda: dcn.dcn_forward(xb, off, mask, wt, b, **kw))
            p_ms = (time_ms(lambda: deform_conv2d_windowed_ref(xb, off, mask, wt, b,
                                                               anchor=g16, **kw),
                            iters=3, warmup=1), None)
        n_px = hw[0] * hw[1]
        bnd = bound([xb, off, mask, wt, b], [gotb], 2 * n_px * c * 9 * c + 9 * n_px * c * 9,
                    "bfloat16")
        record("dcn_fwd_general", mode, 0, err, rel, k_ms, p_ms, None, bnd, route="general",
               clamp_ms=c_ms[0], clamp_device_ms=c_ms[1], anchored_vs_clamp_max_abs=moved,
               bound_fraction=bnd[0] / k_ms[1],
               geometry=f"band {g16.band} xtile {g16.xtile} dl {g16.dl_r:g}/{g16.dl_c:g}",
               digest=digest(got, gotb))

        # ---- D, anchored shared taps, at the amp step's plane -------------
        n, thw = 2, (192, 192)
        mode = f"anchored mid{mid} dcn_3 C{c} O{c} G1 3x3 ({n},{c},{thw[0]},{thw[1]}) D={d}"
        x, gout = rn(n, c, *thw), rn(n, c, *thw)
        off = (_smooth(gen, 2, thw, 40.0, n=n) + rn(n, 2, *thw)).contiguous()
        mask = torch.rand(n, 1, *thw, generator=gen).cuda()
        wt, bias = rn(c, c, 3, 3, std=0.2), rn(c)
        g32, g16 = (an.dcn_geometry(*thw, c, c, 1, 3, d, bf16=bf16, shared_taps=True,
                                    shared_mask=True, fullgrad=True) for bf16 in (False, True))
        beyond(off, g16, f"D {mode}")

        def kern(*a, g=None):
            return dcn.deform_conv2d_windowed(*a, anchor=g, **kw)

        def plain(*a, g=None):
            return deform_conv2d_windowed_ref(*a, anchor=g, **kw)

        ops = (x, off, mask, wt, bias)
        before = now()
        _, got = _grads(functools.partial(kern, g=g32), ops, gout)
        _, want = _grads(functools.partial(plain, g=g32), ops, gout)
        xb, gb = x.to(torch.bfloat16), gout.to(torch.bfloat16)
        _, gotb = _grads(functools.partial(kern, g=g16), (xb, *ops[1:]), gb)
        _, wantb = _grads(functools.partial(plain, g=g16), (xb.float(), *ops[1:]), gb.float())
        torch.cuda.synchronize()
        counted(f"D {mode}", before, 2, 2)
        err = _check_grads(f"[widths] D {mode} f32", got, want, 1e-4)[0]
        _, rel = _check_grads(f"[widths] D {mode} bf16", gotb, wantb, 2e-2)
        _, table = dcn.dcn_forward(xb, off, mask, wt, bias, anchor=g16, with_table=True, **kw)

        def bwd():
            return dcn.dcn_backward(xb, off, mask, wt, gb, anchor=g16, table=table, **kw)

        bits = same_bits(f"D {mode}", lambda: torch.cat([t.flatten() for t in bwd()[1:]]))
        anch, clamp = bwd(), dcn.dcn_backward(xb, off, mask, wt, gb, **kw)
        moved = float((anch[1] - clamp[1]).abs().max())
        if not moved > 0.1 * float(anch[1].abs().max()):
            fail(f"[widths] D {mode}: anchored and clamped d-offset differ by only {moved}")
        k_ms = measure(bwd)
        c_ms = measure(lambda: dcn.dcn_backward(xb, off, mask, wt, gb, **kw))
        p_ms = _time_backward(functools.partial(plain, g=g16), (xb, *ops[1:]), gb, iters=5)
        n_px = n * thw[0] * thw[1]
        bnd = bound([xb, off, mask, wt, gb, table], list(anch), n_px * 9 * c * (4 * c + 22),
                    "bfloat16")
        record("dcn_bwd_general", mode, 0, err, rel, k_ms, p_ms, None, bnd, route="general",
               clamp_ms=c_ms[0], clamp_device_ms=c_ms[1], anchored_vs_clamp_max_abs=moved,
               bound_fraction=bnd[0] / k_ms[1],
               geometry=f"band {g16.band} xtile {g16.xtile} dl {g16.dl_r:g}/{g16.dl_c:g}",
               digest=digest(bits))
    return modes


@contextlib.contextmanager
def general_route():
    """Every call of kernels A, D and E takes the general route, the tuned
    widths too (``dcn.forced_route``; the control of phase 15(b))."""
    from crfp_torch.ops.cuda import dcn

    dcn.forced_route = "general"
    try:
        yield
    finally:
        dcn.forced_route = None


@contextlib.contextmanager
def planted_fault():
    """:data:`PLANTED_FAULT`: every call of kernel A (the dispatchers call
    ``dcn.dcn_forward`` by this name) takes its mask times 0.98. Phase
    15(b) holds its bf16 frames outside the bf16 limit. (On the seeded
    runtime every offset lies past its window, so a fault in the sample
    positions would not show there: 15(a) holds those.)"""
    from crfp_torch.ops.cuda import dcn

    real = dcn.dcn_forward

    def faulty(x, offset, mask, *args, **kwargs):
        return real(x, offset, mask * 0.98, *args, **kwargs)

    dcn.dcn_forward = faulty
    try:
        yield
    finally:
        dcn.dcn_forward = real


def _width_runtime(mid: int, dtype, anchored: bool = False):
    """CRFPRuntimeV18 at ``mid`` on the card, 1080p / warp 720^2, windows
    8/32 (``anchored``: bench.py's _DEPLOY flags, hr_s2d and dcn_anchor),
    seeded weights with random DCN heads."""
    import torch

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18

    cfg = ModelConfig(mid_channels=mid, dcn_window=8, dcn_window_hr=32, hr_s2d=anchored,
                      dcn_anchor=anchored)
    model = _perturb_dcn(CRFPRuntimeV18(cfg, warp_size=WARP, device="cuda", seed=15), 16)
    return model.to(dtype or torch.float32).eval()


def _width_trainer(amp: bool, lr_rate: float, mid: int, dg: int, k: int, seed: int = 15,
                   anchor: bool = False):
    """(model, optimizer, train_step) of the recipe's v18 trunk (windows
    8/32, remat) at this width, seeded with random DCN heads; ``anchor``:
    anchored on the training grid as phase 14(b) trains (``hr_s2d``,
    ``dcn_anchor`` + ``dcn_anchor_vjp``)."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.train.loop import TrainConfig, make_optimizer, make_train_step

    cfg = ModelConfig(mid_channels=mid, deform_groups=dg, dcn_kernel=k, dcn_window=8,
                      dcn_window_hr=32, remat=True, hr_s2d=anchor, dcn_anchor=anchor,
                      dcn_anchor_vjp=anchor)
    model = _perturb_dcn(CRFP(cfg, device="cuda", seed=seed), seed + 1)
    tc = TrainConfig(amp=amp, flow_freeze_iters=0, lr_rate=lr_rate)
    return model, make_optimizer(model, tc), make_train_step(model, tc)


def phase_widths(gen, data: str, tmp: Path) -> tuple[list, dict]:
    """Phase 15: every DCN width the JAX kernels take, through the general
    route of A, D and E. (a) the kernels at every width of :data:`WIDTHS`
    (:func:`_width_kernels`); (b) the paths at full width, seeded weights
    with random DCN heads, kernels against plain versions, launch counts
    and the general route's share of them asserted:
    1. v18 serving (CRFPRuntimeV18, 1080p / warp 720^2, t = 5, windows 8/32)
       at mid 24 (A general 4 a steady frame) and mid 64 (dcn_3 general:
       A 1; dcn_0/1/2 on the O = 64 tuned route): f32 >= 80 dB and max|d|
       <= 1e-3 a frame, at mid 24 also bf16 at WIDTHS_BF16_DB and
       WIDTHS_BF16_DMAX (set for seeded weights between the sound
       readings and the planted faults'), and :func:`planted_fault`'s
       frames outside them; the control: mid 32 in bf16 through the
       tuned routes and through the general route forced on the same
       weights, each against the plain versions at those limits;
    2. the gate's StreamingRunner at mid 24 on 4 frames of a gate clip:
       EXACT (A 4, B 3 a steady frame, A all general) and DEPLOY with
       dcn_fused (E 3, A 1, B 3, every DCN general; anchored dcn_3 and HR
       warp), in f32 at phase 3's limits, DEPLOY in bf16 at phase 8's
       (>= 60 dB a frame against the plain versions);
    3. anchored serving (_DEPLOY) at mid 24 on phase 12's panning clip, f32
       and bf16 (bf16 at WIDTHS_BF16_DB; A 1, B 1 anchored a steady frame),
       the same weights served with the plain clamp outside those limits,
       as phase 12 holds them;
    4. one f32 train step of the recipe (B 2, T 7, GT 192) at mid 24 and
       mid 64, then dg 16 and dcn_kernel 5 at mid 32, through the kernels
       against the plain versions at phase 6's limits, and one amp step each
       that must stay finite; one anchored f32 step at mid 24
       (``dcn_anchor`` + ``dcn_anchor_vjp``, ``hr_s2d``) on phase 14(b)'s
       moving clips at phase 6's limits, dcn_3's anchored A and D on the
       general route;
    5. one step of python -m crfp_torch.main with train.sh's flags and
       --mid_channels 24 (batch 24: the tree's 24 windows) on ``data``.
    Returns (the records of (a), {path: general-route launch counts})."""
    import numpy as np
    import torch

    from crfp_torch import main as cli
    from crfp_torch.bench import card_line
    from crfp_torch.bench import deploy_gate as dg
    from crfp_torch.bench.quality_window import panning_clip
    from crfp_torch.bench.train import RECIPE
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.models.streaming import StreamingRunner

    t_lap = time.perf_counter()

    def lap(what):
        nonlocal t_lap
        now = time.perf_counter()
        print(f"[time] phase 15 {what}: {now - t_lap:.1f} s")
        t_lap = now

    modes = _width_kernels(gen)
    lap("(a) kernels")
    general = {}
    t, steady = WIDTH_FRAMES, WIDTH_FRAMES - 1
    rng = np.random.default_rng(15)
    lrs = torch.from_numpy(rng.uniform(0, 1, (t, 1, *LR_HW, 3)).astype(np.float32)).cuda()
    fvs = torch.from_numpy(rng.uniform(0, 1, (t, 1, FV, FV, 3)).astype(np.float32)).cuda()

    def serve(model, lrs_, fvs_, dtype):
        outs = []
        with torch.inference_mode():
            for i in range(t):
                lr, fv = lrs_[i].to(dtype), fvs_[i].to(dtype)
                x_lr, x_hr = model.encode(lr, fv)
                if i == 0:
                    state, out = model.step0(lr, x_lr, x_hr)
                else:
                    state, out = model.step(state, lr, lrs_[i - 1].to(dtype), x_lr, x_hr)
                outs.append(out.float())
        torch.cuda.synchronize()
        return outs

    def held(tag, run, expect, expect_general, limits, shape, hr_chains=True):
        with plain_kernels(hr_chains):
            want = run()
        _zero_counts()
        got = run()
        launches, gen_l = _counts(), _general_counts()
        print(f"[widths] {tag}: launches {launches}, general route {gen_l}")
        if launches != expect or gen_l != expect_general:
            fail(f"[widths] {tag}: launches {launches} / general {gen_l} != expected "
                 f"{expect} / {expect_general}")
        _frames_agree(f"[widths] {tag}", got, want, *limits, shape=shape)
        return gen_l, got, want

    def outside(tag, faulty, want, limits, versus):
        # a planted fault's frames must fall outside the limit that holds the
        # kernels, which then fails a kernel with that fault
        readings = _frames_agree(f"[widths] {tag}", faulty[1:], want[1:], -math.inf, None,
                                 versus=versus)
        inside = [i + 1 for i, (p, d_) in enumerate(readings)
                  if p >= limits[0] and (limits[1] is None or d_ <= limits[1])]
        if inside:
            fail(f"[widths] {tag}: {versus} frames {inside} fall inside the kernels' limit "
                 f"(>= {limits[0]:g} dB, max|d| <= {limits[1]}), which then cannot fail "
                 f"kernels with that fault")

    # 1. serving
    serve_expect = _expect(dcn_fwd=4 * steady, flow_warp=2 * steady, emit=t)
    for mid, a_gen, dtypes in ((24, 4, (torch.float32, torch.bfloat16)),
                               (64, 1, (torch.float32,))):
        for dtype in dtypes:
            model = _width_runtime(mid, dtype)
            bf16 = dtype == torch.bfloat16
            limits = (WIDTHS_BF16_DB, WIDTHS_BF16_DMAX) if bf16 else (80.0, 1e-3)
            run = functools.partial(serve, model, lrs, fvs, dtype)
            got, _, want = held(f"serving mid {mid} {'bf16' if bf16 else 'f32'}", run,
                                serve_expect, {"dcn_fwd": a_gen * steady, "dcn_bwd": 0,
                                               "dcn_fused": 0}, limits, (1, *HR_HW, 3),
                                hr_chains=not bf16)
            if mid == 24 and bf16:
                general["serving mid 24 bf16"] = got
                with planted_fault():
                    faulty = run()
                outside(f"serving mid {mid} bf16, {PLANTED_FAULT}", faulty, want, limits,
                        "planted fault vs plain")
            del model
    # the control: mid 32 in bf16, the tuned routes and the general one
    # forced on the same weights, each against the plain versions
    model = _width_runtime(32, torch.bfloat16)
    run32 = functools.partial(serve, model, lrs, fvs, torch.bfloat16)
    with plain_kernels(hr_chains=False):
        want = run32()
    tuned = run32()
    _zero_counts()
    with general_route():
        forced = run32()
    if _general_counts()["dcn_fwd"] != 4 * steady:
        fail(f"[widths] serving mid 32 bf16, general route forced: {_general_counts()}")
    for tag, got in (("tuned routes", tuned), ("general route forced", forced)):
        _frames_agree(f"[widths] serving mid 32 bf16 {tag}", got, want, WIDTHS_BF16_DB,
                      WIDTHS_BF16_DMAX, shape=(1, *HR_HW, 3))
    _frames_agree("[widths] serving mid 32 bf16", forced, tuned, WIDTHS_BF16_DB,
                  WIDTHS_BF16_DMAX, versus="general vs tuned routes")
    del model
    lap("(b1) serving mid 24, 64; the mid-32 control")

    # 2. the gate's runner at mid 24
    lr, hr, gaze = dg.gate_clip(np.random.default_rng(24), 50.0, GATE_LR_HW, MID16_FRAMES)
    gsteady = MID16_FRAMES - 1
    for tag, cfg, dtype, limits, expect, expect_gen in (
        ("EXACT f32", ModelConfig(mid_channels=24), torch.float32, (80.0, 1e-3),
         _expect(dcn_fwd=4 * gsteady, flow_warp=3 * gsteady),
         {"dcn_fwd": 4 * gsteady, "dcn_bwd": 0, "dcn_fused": 0}),
        ("DEPLOY f32 dcn_fused", None, torch.float32, (80.0, 1e-3),
         _expect(dcn_fused=3 * gsteady, dcn_fwd=gsteady, flow_warp=3 * gsteady),
         {"dcn_fwd": gsteady, "dcn_bwd": 0, "dcn_fused": 3 * gsteady}),
        # the batch trunk's bf16 frames against plain versions at the gate's
        # own limit (phase 8); the runtime slices hold phase 12's
        ("DEPLOY bf16 dcn_fused", None, torch.bfloat16, (GATE_PLAIN_BF16_DB, None),
         _expect(dcn_fused=3 * gsteady, dcn_fwd=gsteady, flow_warp=3 * gsteady),
         {"dcn_fwd": gsteady, "dcn_bwd": 0, "dcn_fused": 3 * gsteady}),
    ):
        if cfg is None:  # the gate's DEPLOY configuration (bench/deploy_gate.py)
            cfg = ModelConfig(mid_channels=24, dcn_window=8, dcn_window_hr=32, hr_s2d=True,
                              dcn_anchor=True, dcn_fused=True)
        runner = StreamingRunner(_perturb_dcn(CRFP(cfg, device="cuda", seed=24), 25).to(dtype))
        got, *_ = held(f"gate mid 24 {tag}",
                       lambda: [out for _, out, _ in dg.stream_clip(runner, lr, hr, gaze)],
                       expect, expect_gen, limits, (1, *hr.shape[1:3], 3))
        if tag.startswith("DEPLOY bf16"):
            general["gate DEPLOY mid 24 bf16"] = got
        del runner
    lap("(b2) gate mid 24")

    # 3. anchored serving at mid 24, on phase 12's panning clip
    alrs, ahrs = (torch.from_numpy(a[:, None]).cuda()
                  for a in panning_clip(t, LR_HW, ANCHOR_V, seed=15))
    afvs = ahrs[:, :, :FV, :FV].contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        model = _width_runtime(24, dtype, anchored=True)
        tag = f"anchored serving mid 24 {'bf16' if bf16 else 'f32'}"
        limits = (WIDTHS_BF16_DB, WIDTHS_BF16_DMAX) if bf16 else (80.0, 1e-3)
        _, got, _ = held(tag, functools.partial(serve, model, alrs, afvs, dtype), serve_expect,
                         {"dcn_fwd": 4 * steady, "dcn_bwd": 0, "dcn_fused": 0}, limits,
                         (1, *HR_HW, 3), hr_chains=not bf16)
        anchored = _anchor_counts()
        if anchored["dcn_fwd"] != steady or anchored["flow_warp"] != steady:
            fail(f"[widths] {tag}: anchored launches {anchored}")
        # the same weights served with the plain clamp (a kernel that drops
        # the anchor), as phase 12 holds it
        clamp_model = _width_runtime(24, dtype)
        clamp_model.load_state_dict(model.state_dict())
        outside(f"{tag}, plain clamp", serve(clamp_model, alrs, afvs, dtype), got, limits,
                "anchored vs plain-clamp")
        del model, clamp_model
    lap("(b3) anchored serving mid 24")

    # 4. train steps at the recipe's shapes
    batches = _train_batches()
    n_rec = RECIPE["t"] - 1
    for tag, mid, dgn, k in WIDTH_TRUNKS:
        # the general route's share: A and D at every stage where the rule
        # says so (f32 A at O = 64 is tuned, dcn_3 at mid 64 general)
        from crfp_torch.ops.cuda import dcn

        cpg_route = dcn.width_route("dcn_fwd", mid, mid, dgn, k, k)
        a3 = dcn.width_route("dcn_fwd", mid // 8, mid // 8, 1, k, k, shared=True)
        d_route = dcn.width_route("dcn_bwd", mid, mid, dgn, k, k)
        d3 = dcn.width_route("dcn_bwd", mid // 8, mid // 8, 1, k, k, shared=True)
        a_gen = 2 * n_rec * (3 * (cpg_route == "general") + (a3 == "general"))
        d_gen = n_rec * (3 * (d_route == "general") + (d3 == "general"))
        expect_gen = {"dcn_fwd": a_gen, "dcn_bwd": d_gen, "dcn_fused": 0}
        _train_vs_plain(f"[widths] {tag} train", 1, 2e-4, _train_expect(1), batches,
                        builder=_width_trainer, expect_general=expect_gen, mid=mid, dg=dgn, k=k)
        _zero_counts()
        _, opt, step = _width_trainer(True, 2e-4, mid, dgn, k)
        loss = float(step(opt, batches[1], 0)["loss"])
        torch.cuda.synchronize()
        launches, gen_l = _counts(), _general_counts()
        print(f"[widths] {tag} amp step: loss {loss:.6f}; launches {launches}, general {gen_l}")
        if not math.isfinite(loss) or launches != _train_expect(1):
            fail(f"[widths] {tag} amp step: loss {loss}, launches {launches}")
        if tag == "mid24":
            general["amp step mid 24"] = gen_l
    # anchored at mid 24 (dcn_anchor + dcn_anchor_vjp, hr_s2d) on phase
    # 14(b)'s moving noise clips: dcn_3's anchored A and D on the general
    # route (every A and D of mid 24 is general), the HR warp's on B and D
    from crfp_torch.bench.train import device_batches

    _train_vs_plain("[widths] mid24 anchored train", 1, 2e-4, _train_expect(1),
                    device_batches(1, seed=14, v_max=ANCHOR_TRAIN_V), builder=_width_trainer,
                    expect_anchored=_anchor_train_expect(1, n_rec),
                    expect_general={"dcn_fwd": 8 * n_rec, "dcn_bwd": 4 * n_rec, "dcn_fused": 0},
                    mid=24, dg=8, k=3, anchor=True)
    lap("(b4) train steps")

    # 5. python -m crfp_torch.main at mid 24, one step
    run = tmp / "train_mid24"
    argv = TRAIN_SH + ["--save_dir", str(run), "--dataset_dir", data,
                       "--frame_cache", str(tmp / "cache"), "--mid_channels", "24",
                       "--batch_size", "24", "--val_every", "999999", "--viz_every", "0",
                       "--save_every", "999999"]
    _zero_counts()
    t0 = time.perf_counter()
    out = cli.main(argv)
    wall = time.perf_counter() - t0
    got, gen_l = _counts(), _general_counts()
    losses = [m["loss"] for m in out["metrics"]]
    print(f"[widths] main, train.sh's flags + --mid_channels 24 --batch_size 24: "
          f"{out['step']} step(s) in {wall:.2f} s (host clock; {card_line()}); losses "
          f"{losses}; launches {got}, general {gen_l}")
    want = _main_expect(train_steps=out["step"])
    if out["step"] != 1 or not all(math.isfinite(v) for v in losses) or got != want or \
            gen_l != {"dcn_fwd": want["dcn_fwd"], "dcn_bwd": want["dcn_bwd"], "dcn_fused": 0}:
        fail(f"[widths] main at mid 24: {out['step']} steps, losses {losses}, launches {got} / "
             f"general {gen_l} != {want}")
    lap("(b5) main mid 24")
    return modes, general


# ---- phase 16: per-tap anchored windows (DCNAlign(anchor=True), per-tap) ---
# (a)'s widths: (id, C = O, G, plane, calls a unit); the per-tap stages at
# D = 8 in 8 groups. The dcn_fwd_tap_anchored entry's unit is one call at
# mid 32 in bf16 on the serving plane; (b)'s, dcn_bwd_tap_anchored's, one at
# the amp step's (2,32,48,48).
TAP_ANCHOR_D = 8
TAP_ANCHOR_WIDTHS = [("mid32", 32, 8, (180, 180), 1), ("mid16", 16, 8, (180, 180), 0),
                     ("mid24", 24, 8, (180, 180), 0), ("O64 cpg8", 64, 8, (180, 320), 0),
                     ("O64 cpg4", 64, 16, (180, 320), 0), ("O64 cpg16", 64, 4, (180, 320), 0),
                     ("O64 cpg64", 64, 1, (180, 320), 0)]
TAP_ANCHOR_BWD = [("mid32", 32, 8, 1), ("mid24", 24, 8, 0)]
TAP_ANCHOR_STEPS, TAP_ANCHOR_LR = 3, 2e-4


# the motion of phase 16's fields: (dy, dx) = (12, 40) px, past D = 8 in
# every cell and quantum (rows: 8 or 16; columns: 16-128)
TAP_ANCHOR_SHIFT = (12.0, 40.0)


def _tap_field(gen, n: int, g: int, hw) -> "torch.Tensor":
    """Per-tap offsets (n, g*18, *hw) on the card: a shift of
    :data:`TAP_ANCHOR_SHIFT` plus a smooth field of std 20 px varying over
    ~32 px (its cells' anchors pass D = 8), the same for every tap, plus 2
    px of noise a tap."""
    import torch

    shift = torch.tensor(TAP_ANCHOR_SHIFT).view(1, 2, 1, 1).cuda()
    base = (_smooth(gen, 2, hw, 20.0, n=n) + shift).repeat(1, g * 9, 1, 1)
    return (base + (torch.randn(n, g * 18, *hw, generator=gen) * 2.0).cuda()).contiguous()


def _tap_kernels(gen) -> list:
    """Phase 16(a) and (b): kernels A and D in per-tap anchored mode against
    their plain versions (see the module note). Returns the records."""
    import torch

    from crfp_torch.ops import anchor as an
    from crfp_torch.ops.cuda import dcn
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    modes = []
    record = functools.partial(_record, modes)
    d = TAP_ANCHOR_D
    bf = torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    def geoms(hw, c, g, fullgrad):
        return tuple(an.dcn_geometry(*hw, c, c, g, 3, d, bf16=b16, shared_taps=False,
                                     shared_mask=False, fullgrad=fullgrad)
                     for b16 in (False, True))

    def beyond(off, geom, g, what):
        reach = float(an.anchor_table(off, geom, g).abs().max())
        print(f"[tap anchor] {what}: anchors up to {reach:g} px (A = {geom.a_y}/{geom.a_x}, "
              f"reach {geom.reach:g}), |offset| up to {float(off.abs().max()):.1f} px")
        if reach <= d:
            fail(f"[tap anchor] {what}: no cell's anchor passes D = {d}")

    def same_bits(tag, fn):
        first = fn()
        if not (torch.equal(fn(), first) and torch.equal(captured(fn), first)):
            fail(f"[tap anchor] {tag}: two runs and a CUDA-graph replay are not bit-equal")
        return first

    def now():
        return (dcn.tap_anchor_launches, dcn.bwd_tap_anchor_launches, dcn.general_launches,
                dcn.bwd_general_launches)

    def counted(tag, before, fwd, bwd, general):
        got = tuple(a - b for a, b in zip(now(), before))
        want = (fwd, bwd, fwd if general[0] else 0, bwd if general[1] else 0)
        if got != want:
            fail(f"[tap anchor] {tag}: per-tap anchored launches of A, D and their general "
                 f"route's {got}, expected {want}")

    # ---- (a) A ------------------------------------------------------------
    for wid, c, g, hw, calls in TAP_ANCHOR_WIDTHS:
        route = dcn.width_route("dcn_fwd", c, c, g, 3, 3, bf16=True, tap_anchor=True)
        x = rn(1, c, *hw)
        off = _tap_field(gen, 1, g, hw)
        mask = torch.rand(1, g * 9, *hw, generator=gen).cuda()
        wt, b = rn(c, c, 3, 3, std=0.1), rn(c)
        xb = x.to(bf)
        for grid in ("inference", "training"):
            g32, g16 = geoms(hw, c, g, grid == "training")
            mode = f"{wid} C{c} O{c} G{g} (1,{c},{hw[0]},{hw[1]}) D={d} {grid} grid"
            beyond(off, g16, g, f"A {mode}")
            before = now()
            with torch.no_grad():
                got = dcn.dcn_forward(x, off, mask, wt, b, max_displacement=d, anchor=g32)
                ref = deform_conv2d_windowed_ref(x, off, mask, wt, b, max_displacement=d,
                                                 anchor=g32)
                refb = deform_conv2d_windowed_ref(xb.float(), off, mask, wt, b,
                                                  max_displacement=d, anchor=g16)

                def call():
                    return dcn.dcn_forward(xb, off, mask, wt, b, max_displacement=d,
                                           anchor=g16)

                gotb = call()
                torch.cuda.synchronize()
                counted(f"A {mode}", before, 2, 0, (route == "general", False))
                err = float((got - ref).abs().max())
                limit = 2e-2 * float(refb.abs().max())
                rel = float((gotb.float() - refb).abs().max()) / float(refb.abs().max())
                if not (err <= 1e-4 and rel <= 2e-2):
                    fail(f"[tap anchor] A {mode}: f32 max|d| {err} (limit 1e-4), bf16 {rel} of "
                         f"max|ref| (limit 2e-2)")
                if not torch.equal(same_bits(f"A {mode}", call), gotb):
                    fail(f"[tap anchor] A {mode}: the first call and its repeats differ")
                clamp = dcn.dcn_forward(xb, off, mask, wt, b, max_displacement=d)
                moved = float((clamp.float() - refb).abs().max())
                if not moved > limit:
                    fail(f"[tap anchor] A {mode}: the clamped output is within the limit of "
                         f"the anchored plain version ({moved} <= {limit})")
                if grid == "training":
                    continue
                k_ms = measure(call)
                c_ms = measure(lambda: dcn.dcn_forward(xb, off, mask, wt, b, max_displacement=d))
                p_ms = (time_ms(lambda: deform_conv2d_windowed_ref(
                    xb, off, mask, wt, b, max_displacement=d, anchor=g16), iters=3, warmup=1), None)
            n_px = hw[0] * hw[1]
            bnd = bound([xb, off, mask, wt, b], [gotb], 2 * n_px * c * 9 * c + 9 * n_px * c * 9,
                        "bfloat16")
            record("dcn_fwd_tap_anchored", mode, calls, err, rel, k_ms, p_ms, None, bnd,
                   route=route, clamp_ms=c_ms[0], clamp_device_ms=c_ms[1],
                   anchored_vs_clamp_max_abs=moved, bound_fraction=bnd[0] / k_ms[1],
                   geometry=f"band {g16.band} xtile {g16.xtile} dl {g16.dl_r:g}/{g16.dl_c:g} "
                            f"reach {g16.reach:g}",
                   digest=digest(got, gotb))

    # ---- (b) D, at the amp step's plane, on the training grid --------------
    for wid, c, g, calls in TAP_ANCHOR_BWD:
        n, thw = 2, (48, 48)
        route = dcn.width_route("dcn_bwd", c, c, g, 3, 3, tap_anchor=True)
        mode = f"{wid} C{c} O{c} G{g} ({n},{c},{thw[0]},{thw[1]}) D={d} training grid"
        x, gout = rn(n, c, *thw), rn(n, c, *thw)
        off = _tap_field(gen, n, g, thw)
        mask = torch.rand(n, g * 9, *thw, generator=gen).cuda()
        wt, bias = rn(c, c, 3, 3, std=0.1), rn(c)
        g32, g16 = geoms(thw, c, g, True)
        beyond(off, g16, g, f"D {mode}")

        def kern(*a, geom=None):
            return dcn.deform_conv2d_windowed(*a, max_displacement=d, anchor=geom)

        def plain(*a, geom=None):
            return deform_conv2d_windowed_ref(*a, max_displacement=d, anchor=geom)

        ops = (x, off, mask, wt, bias)
        before = now()
        _, got = _grads(functools.partial(kern, geom=g32), ops, gout)
        _, want = _grads(functools.partial(plain, geom=g32), ops, gout)
        xb, gb = x.to(bf), gout.to(bf)
        _, gotb = _grads(functools.partial(kern, geom=g16), (xb, *ops[1:]), gb)
        _, wantb = _grads(functools.partial(plain, geom=g16), (xb.float(), *ops[1:]),
                          gb.float())
        torch.cuda.synchronize()
        counted(f"D {mode}", before, 2, 2, (dcn.width_route("dcn_fwd", c, c, g, 3, 3,
                                                            tap_anchor=True) == "general",
                                            route == "general"))
        err = _check_grads(f"[tap anchor] D {mode} f32", got, want, 1e-4)[0]
        _, rel = _check_grads(f"[tap anchor] D {mode} bf16", gotb, wantb, 2e-2)
        _, table = dcn.dcn_forward(xb, off, mask, wt, bias, max_displacement=d, anchor=g16,
                                   with_table=True)

        def bwd():
            return dcn.dcn_backward(xb, off, mask, wt, gb, max_displacement=d, anchor=g16,
                                    table=table)

        bits = torch.cat([t.flatten() for t in bwd()[1:]])
        if not torch.equal(torch.cat([t.flatten() for t in bwd()[1:]]), bits):
            fail(f"[tap anchor] D {mode}: d-offset, d-mask or dW differ over two runs")
        anch, clamp = bwd(), dcn.dcn_backward(xb, off, mask, wt, gb, max_displacement=d)
        moved = float((anch[1] - clamp[1]).abs().max())
        if not moved > 0.1 * float(anch[1].abs().max()):
            fail(f"[tap anchor] D {mode}: anchored and clamped d-offset differ by only {moved}")
        k_ms = measure(bwd)
        c_ms = measure(lambda: dcn.dcn_backward(xb, off, mask, wt, gb, max_displacement=d))
        p_ms = _time_backward(functools.partial(plain, geom=g16), (xb, *ops[1:]), gb, iters=5)
        n_px = n * thw[0] * thw[1]
        bnd = bound([xb, off, mask, wt, gb, table], list(anch), n_px * 9 * c * (4 * c + 22),
                    "bfloat16")
        record("dcn_bwd_tap_anchored", mode, calls, err, rel, k_ms, p_ms, None, bnd, route=route,
               clamp_ms=c_ms[0], clamp_device_ms=c_ms[1], anchored_vs_clamp_max_abs=moved,
               bound_fraction=bnd[0] / k_ms[1],
               geometry=f"band {g16.band} xtile {g16.xtile} dl {g16.dl_r:g}/{g16.dl_c:g} "
                        f"reach {g16.reach:g}",
               digest=digest(bits))
    return modes


def _tap_stage(seed: int):
    """``DCNAlign(anchor=True, anchor_vjp=True)`` as a per-tap stage at mid
    32 (8 groups, window 8) on the card, f32, seeded: random offset and mask
    heads (offset std 0.02, so that the taps' offsets spread a few pixels
    around the flow) and DCN weight and bias in place of the init's zero
    heads and identity weight."""
    import torch

    from crfp_torch.nn.align import DCNAlign

    torch.manual_seed(seed)
    stage = DCNAlign(MID, 8, 3, 10.0, window=TAP_ANCHOR_D, anchor=True, anchor_vjp=True)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in stage.named_parameters():
            if name.startswith(("dcn_offset", "dcn_mask", "dcn_weight", "dcn_bias")):
                std = 0.02 if name.startswith("dcn_offset") else 0.2
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return stage.cuda()


def phase_anchor_per_tap(gen) -> tuple[list, dict]:
    """Phase 16 (see the module note). Returns (the records of (a) and (b),
    the per-tap anchored launches of A and D over (c)'s steps)."""
    import torch

    from crfp_torch.ops.cuda import dcn

    modes = _tap_kernels(gen)

    # ---- (c) the module: DCNAlign per-tap anchored, f32 ---------------------
    def inputs(n, hw):  # the flow (dx, dy) of _tap_field's motion
        cur, pre, pre_al = (torch.randn(n, MID, *hw, generator=gen).cuda() for _ in range(3))
        shift = torch.tensor(TAP_ANCHOR_SHIFT[::-1]).view(1, 2, 1, 1).cuda()
        return cur, pre, pre_al, _smooth(gen, 2, hw, 20.0, n=n) + shift

    stage = _tap_stage(16)
    args = inputs(1, (180, 180))
    with torch.no_grad():
        got, _ = stage(*args)
        with plain_kernels():
            want, _ = stage(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[tap anchor] DCNAlign(anchor=True) per-tap stage, mid 32, (1,32,180,180) f32 "
          f"inference: kernels vs plain max|d| {err:.3e} (limit 1e-4)")
    if not err <= 1e-4:
        fail(f"[tap anchor] the per-tap anchored stage's inference: max|d| {err} > 1e-4")

    n, hw, steps, lr = 2, (48, 48), TAP_ANCHOR_STEPS, TAP_ANCHOR_LR
    batches = [(*inputs(n, hw), torch.randn(n, MID, *hw, generator=gen).cuda())
               for _ in range(steps)]

    def train(path):
        model = _tap_stage(16)
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        losses, first = [], None
        for cur, pre, pre_al, flow, target in batches:
            aligned, _ = model(cur, pre, pre_al, flow)
            loss = ((aligned - target) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            if first is None:  # every leaf's gradient before the first step
                first = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
            opt.step()
            losses.append(float(loss.detach()))
        print(f"[tap anchor] DCNAlign per-tap anchored, {steps} Adam steps {path}: "
              f"losses {losses}")
        return losses, {k: p.detach().clone() for k, p in model.named_parameters()}, first

    with plain_kernels():
        want_losses, want_params, want_grads = train("plain")
    _zero_counts()
    got_losses, got_params, got_grads = train("kernels")
    torch.cuda.synchronize()
    # a wrong backward moves the first step's gradients, which Adam's
    # bounded steps would hide in the parameters
    grad_rel = max(_check_grads(f"[tap anchor] DCNAlign per-tap anchored, first step, {k}",
                                [got_grads[k]], [want_grads[k]], 1e-4)[1] for k in want_grads)
    print(f"[tap anchor] the first step's gradients of {len(want_grads)} leaves, kernels vs "
          f"plain: max|d| {grad_rel:.3e} of max|ref| (limit 1e-4)")
    launches = {"dcn_fwd": dcn.tap_anchor_launches, "dcn_bwd": dcn.bwd_tap_anchor_launches}
    print(f"[tap anchor] per-tap anchored launches over {steps} steps: {launches}, "
          f"all launches {_counts()}")
    if launches != {"dcn_fwd": steps, "dcn_bwd": steps} or \
            _counts() != _expect(dcn_fwd=steps, dcn_bwd=steps):
        fail(f"[tap anchor] the stage's steps launched {launches} per-tap anchored "
             f"({_counts()} in all), expected {steps} of A and of D")
    worst = max(float((got_params[k] - want_params[k]).abs().max()) for k in want_params)
    for i, (g_, w_) in enumerate(zip(got_losses, want_losses)):
        if not (math.isfinite(g_) and abs(g_ - w_) <= 1e-4 * abs(w_)):
            fail(f"[tap anchor] step {i}: loss {g_} through the kernels, {w_} plain")
    print(f"[tap anchor] max param |d| after {steps} steps {worst:.3e} (limit "
          f"{2 * lr * steps:.1e})")
    if not worst <= 2 * lr * steps:
        fail(f"[tap anchor] parameters differ by {worst} > {2 * lr * steps}")
    return modes, launches


# ---- phase 17: where the amp step's drift comes from (a reading) ---------
DRIFT_SWAPS = ("A", "D", "B", "F")


@contextlib.contextmanager
def one_plain(which: str):
    """The kernel path with one kernel swapped for its plain version: "A"
    the DCN forward (kernel D's backward kept), "D" the DCN backward (kernel
    A's forward kept), "B" the warp (kernel B and its backward, D at k = 1),
    "F" the SSIM map of the loss. The models call the dispatchers by their
    module-level names, as :func:`plain_kernels` swaps them."""
    import torch

    import crfp_torch.models.crfp as cr
    import crfp_torch.nn.align as al
    import crfp_torch.ops.metrics as mt
    from crfp_torch.ops.cuda import dcn
    from crfp_torch.ops.cuda.ssim import ssim_map_ref
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    class PlainForward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, offset, mask, weight, bias, kw):
            out = deform_conv2d_windowed_ref(x, offset, mask, weight, bias, **kw)
            table = None
            if kw["anchor"] is not None:  # the table kernel D reads, from A's pre-pass
                _, table = dcn.dcn_forward(x, offset, mask, weight, bias, with_table=True, **kw)
            ctx.save_for_backward(x, offset, mask, weight, table)
            ctx.kw, ctx.has_bias = kw, bias is not None
            return out

        @staticmethod
        def backward(ctx, g):
            x, offset, mask, weight, table = ctx.saved_tensors
            g = g.to(x.dtype).contiguous()
            dx, doff, dmask, dw = dcn.dcn_backward(x, offset, mask, weight, g, table=table,
                                                   **ctx.kw)
            return dx, doff, dmask, dw, g.float().sum((0, 2, 3)) if ctx.has_bias else None, None

    class PlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, offset, mask, weight, bias, kw):
            ctx.save_for_backward(x, offset, mask, weight, bias)
            ctx.kw = kw
            return dcn.dcn_forward(x, offset, mask, weight, bias, **kw)

        @staticmethod
        def backward(ctx, g):
            leaves = [t.detach().requires_grad_(True) if t is not None else None
                      for t in ctx.saved_tensors]
            with torch.enable_grad():
                out = deform_conv2d_windowed_ref(*leaves, **ctx.kw)
                got = torch.autograd.grad(out, [t for t in leaves if t is not None], g)
            grads = iter(got)
            return (*[next(grads) if t is not None else None for t in leaves], None)

    def dcn_site(fn):
        def call(x, offset, mask, weight, bias=None, *, max_displacement=None,
                 shared_taps=False, shared_mask=False, anchor=None):
            return fn.apply(x, offset, mask, weight, bias,
                            dict(max_displacement=max_displacement, shared_taps=shared_taps,
                                 shared_mask=shared_mask, anchor=anchor))
        return call

    site = {"A": (al, "deform_conv2d_windowed", dcn_site(PlainForward)),
            "D": (al, "deform_conv2d_windowed", dcn_site(PlainBackward)),
            "B": (cr, "flow_warp_windowed", flow_warp_windowed_ref),
            "F": (mt, "ssim_map", ssim_map_ref)}[which]
    saved = getattr(site[0], site[1])
    setattr(site[0], site[1], site[2])
    try:
        yield
    finally:
        setattr(site[0], site[1], saved)


def phase_drift() -> dict:
    """Phase 17 (F2, a reading): phase 14(b)'s anchored amp steps and the
    clamped amp steps it reads beside them, from the anchored checkpoint on
    the same batches: all plain, all kernels, and the kernels with each of
    :data:`DRIFT_SWAPS` swapped for its plain version (:func:`one_plain`).
    Prints every run's losses and each run's largest relative distance from
    the plain run's; returns {config: {run: distance}}."""
    import torch

    from crfp_torch.bench import card_line
    from crfp_torch.bench.train import build_trainer, device_batches

    steps, lr = ANCHOR_TRAIN_STEPS, ANCHOR_TRAIN_LR
    batches = device_batches(steps, seed=14, v_max=ANCHOR_TRAIN_V)
    out = {}
    for config, build in (("anchored", dict(ckpt=str(ANCHOR_CKPT), anchor=True, hr_s2d=True)),
                          ("clamped", dict(ckpt=str(ANCHOR_CKPT)))):
        def run(ctx):
            model, opt, step = build_trainer(amp=True, lr_rate=lr, **build)
            with ctx:
                losses = [float(step(opt, batches[i], i)["loss"]) for i in range(steps)]
            torch.cuda.synchronize()
            return losses

        runs = {"plain": run(plain_kernels()), "kernels": run(contextlib.nullcontext())}
        for which in DRIFT_SWAPS:
            runs[f"{which} plain"] = run(one_plain(which))
        want = runs["plain"]
        dist = {name: max(abs(g - w) / abs(w) for g, w in zip(losses, want))
                for name, losses in runs.items()}
        for name, losses in runs.items():
            print(f"[drift] {config} amp steps, {name:9s}: losses "
                  + ", ".join(f"{v:.6f}" for v in losses)
                  + f"; max relative |d| from plain {dist[name]:.3e}")
        out[config] = dist
    print(f"[drift] {json.dumps(out)} ({card_line()})")
    return out


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
                    help="phases 1, 2, 2b and 5 only (build, kernels against their plain "
                         "versions, device and call times), then a {\"modes\": [...]} "
                         "line; prints no final ok line")
    ap.add_argument("--parallel-only", action="store_true",
                    help="phases 1 and 10 only (build, phase 9's tree, the parallel "
                         "paths); prints no final ok line")
    ap.add_argument("--tools-only", action="store_true",
                    help="phases 1 and 11 only (build, the tools and benches); prints "
                         "no final ok line")
    ap.add_argument("--anchor-only", action="store_true",
                    help="phases 1 and 12 only (build, anchored kernels A and B against "
                         "their plain versions, the anchored slice at full width), then a "
                         "{\"modes\": [...]} line; prints no final ok line")
    ap.add_argument("--anchor-train-only", action="store_true",
                    help="phases 1 and 14 only (build, kernel D's anchored modes against "
                         "their plain versions, anchored train steps, main --dcn_anchor on a "
                         "REDS-shaped tree it writes), then a {\"modes\": [...]} line; prints "
                         "no final ok line")
    ap.add_argument("--widths-only", action="store_true",
                    help="phases 1 and 15 only (build, the general route of kernels A, D "
                         "and E against their plain versions at every width of the flags, "
                         "the paths at full width at mid 24 and 64, dg_num 16, dcn_kernel 5, "
                         "main at --mid_channels 24 on a REDS-shaped tree it writes), then a "
                         "{\"modes\": [...]} line; prints no final ok line")
    ap.add_argument("--anchor-per-tap-only", action="store_true",
                    help="phases 1 and 16 only (build, kernels A and D in per-tap anchored "
                         "mode against their plain versions at every route, DCNAlign's "
                         "per-tap anchored stage through them), then a {\"modes\": [...]} "
                         "line; prints no final ok line")
    ap.add_argument("--drift-only", action="store_true",
                    help="phases 1 and 17 only (build, the amp step's losses with each of A, "
                         "D, B and F swapped for its plain version, anchored and clamped: a "
                         "reading); prints no final ok line")
    ap.add_argument("--models-bf16-only", action="store_true",
                    help="phase 1 and phase 3d's bf16 pyramids and PCD only (build, "
                         "kernels against plain versions in bf16, the X8 bf16 frame's "
                         "ms); prints no final ok line")
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
    for ckpt in (CKPT, GATE_CKPT, MID16_CKPT, ANCHOR_CKPT):
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
    if args.anchor_only:
        anchor_modes, _ = timed("12 anchor", phase_anchor, torch.Generator().manual_seed(12))
        print(f"[done] anchor phase passed in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"modes": anchor_modes}))
        return 0
    if args.anchor_train_only:
        with tempfile.TemporaryDirectory(prefix="crfp_main_") as tmp:
            data = str(_write_reds_tree(Path(tmp))) + "/"
            modes14, _, _ = timed("14 anchored training", phase_anchor_train,
                                  torch.Generator().manual_seed(14), data, Path(tmp))
        print(f"[done] anchored training phase passed in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"modes": modes14}))
        return 0
    if args.widths_only:
        with tempfile.TemporaryDirectory(prefix="crfp_main_") as tmp:
            data = str(_write_reds_tree(Path(tmp))) + "/"
            modes15, _ = timed("15 widths", phase_widths, torch.Generator().manual_seed(15),
                               data, Path(tmp))
        print(f"[done] widths phase passed in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"modes": modes15}))
        return 0
    if args.anchor_per_tap_only:
        modes16, _ = timed("16 per-tap anchored", phase_anchor_per_tap,
                           torch.Generator().manual_seed(16))
        print(f"[done] per-tap anchored phase passed in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"modes": modes16}))
        return 0
    if args.drift_only:
        timed("17 drift", phase_drift)
        print(f"[done] drift phase read in {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.models_bf16_only:
        timed("3d bf16 pyramids and PCD", _models_bf16, _expect())
        print(f"[done] bf16 models passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    gen = torch.Generator().manual_seed(0)
    modes = timed("2 kernels", phase_kernels, gen)
    modes += timed("2b full-resolution chains", phase_hr_conv_kernels)
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
        anchor_modes, anchor_launches = timed("12 anchor", phase_anchor,
                                              torch.Generator().manual_seed(12))
        # phase 14 before phase 13's lines: its (c) runs on phase 9's tree
        modes14, atrain_launches, atrain_anchored = timed(
            "14 anchored training", phase_anchor_train, torch.Generator().manual_seed(14),
            str(Path(tmp) / "REDS_sharp") + "/", Path(tmp))
        # phase 15 too: its main step runs on phase 9's tree
        modes15, width_general = timed("15 widths", phase_widths,
                                       torch.Generator().manual_seed(15),
                                       str(Path(tmp) / "REDS_sharp") + "/", Path(tmp))
    modes16, tap_launches = timed("16 per-tap anchored", phase_anchor_per_tap,
                                  torch.Generator().manual_seed(16))
    modes += anchor_modes

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
        # kernel C's entry holds both its routes: the serving slice's frame
        # takes the conv route (phase 2b), the row route's modes are off it
        kinds = ("emit", "emit_conv") if name == "emit" else (name,)
        ms = [m for m in modes if m["kernel"] in kinds]
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
        # A and B in anchored mode: their time per steady frame of phase 12's
        # anchored slice, beside the clamped call's
        anch = [m for m in ms if m.get("calls_anchor")]
        for key in ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
                    "clamp_ms", "clamp_device_ms", "library_ms") if anch else ():
            if all(m[key] is not None for m in anch):
                extra[f"anchor_{key}"] = sum(m[key] * m["calls_anchor"] for m in anch)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "tpu_counterpart": tpu,
            "routes_on_path": sorted({m["kernel"] for m in on_path}),
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
            # the height-sharded runner's 3 + 3 + 3 frames (windowed,
            # unclamped, anchored)
            "launches_parallel": par_launches[name],
            # over phase 11: the capability ablation and its plain check, the
            # window-quality harnesses, the converted checkpoint, the runtime
            # CLIs and the video tools (the trace table's child excluded)
            "launches_tools": tools_launches[name],
            # phase 12's anchored slice (bench.py's _DEPLOY flags, 5 bf16
            # frames at 1080p / warp 720^2 on the anchored checkpoint); A's
            # and B's anchored-mode launches are among them (A 1, B 1 a
            # steady frame)
            "launches_anchor": anchor_launches[name],
            # phase 14(b)'s anchored amp kernel steps (3 at the recipe,
            # hr_s2d, dcn_anchor + dcn_anchor_vjp); A's, B's and D's
            # anchored-mode launches are among them
            "launches_anchor_train": atrain_launches[name],
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
    # G, H and C's conv route (phase 2b), entries of their own: no TPU kernel
    # (the JAX package leaves these convolutions to XLA); per steady frame of
    # the serving slice, whose launches phase 3 counted, and per step of the
    # stream cells (4 viewers, 1080p, warp = the frame)
    for name, src, what in (
            ("hr_conv_head", "crfp_torch/csrc/hr_conv.cu (hr_conv_head_kernel) + common.cuh",
             "dcn_3's offset and mask head"),
            ("hr_conv_tail", "crfp_torch/csrc/hr_conv.cu (hr_conv_tail_kernel) + common.cuh",
             "forward_resblocks_3"),
            ("emit_conv", "crfp_torch/csrc/emit.cu (emit_kernel_conv) + common.cuh",
             "the finish's leaky_relu and conv_last, before kernel C's emission")):
        ms = [m for m in modes if m["kernel"] == name]

        def per_unit(key, calls, ms=ms):
            return sum(m[key] * m[calls] for m in ms if m[calls] > 0)

        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": None,
            "tpu_counterpart": f"none: {what}, which the JAX package leaves to XLA",
            "launches": serve_launches[name],
            "max_abs_err": max(m["max_abs_err"] for m in ms),
            **{key: per_unit(key, "calls")
               for key in ("ms", "call_ms", "device_ms", "plain_ms", "plain_device_ms",
                           "bound_ms", "fma_f32_ms", "library_ms", "library_call_ms",
                           "library_device_ms", "f32_device_ms")},
            "bound_by": "bytes" if all(m["bound_by"] == "bytes" for m in ms) else "operations",
            **{f"stream_step_{key}": per_unit(key, "calls_stream")
               for key in ("device_ms", "bound_ms", "fma_f32_ms", "library_device_ms",
                           "f32_device_ms")},
            "per_unit_of": serve, "modes": ms,
        })
    # kernel D's anchored modes (phase 14), entries of their own: the TPU's
    # anchored call site :581; per anchored amp step of phase 14(b)
    atrain = ("main-path calls per anchored amp train step (B 2, T 7, GT 192, mid 32, "
              "windows 8/32, hr_s2d, dcn_anchor + dcn_anchor_vjp), bf16 inputs")
    for name, src, what in (
            ("dcn_bwd", "crfp_torch/csrc/dcn_bwd.cu", "dcn_3's shared taps"),
            ("flow_warp_bwd", "crfp_torch/csrc/flow_warp_bwd.cu",
             "k=1, no mask: the HR state warp")):
        ms = [m for m in modes14 if m["kernel"] == name]
        on_path = [m for m in ms if m["calls_anchor_train"] > 0]

        def per_step(key, on_path=on_path):
            if any(m[key] is None for m in on_path):
                return None
            return sum(m[key] * m["calls_anchor_train"] for m in on_path)

        kernels.append({
            "name": f"{name}_anchored", "route": "cuda", "source": src,
            "replaces": "crfp_tpu/ops/pallas/dcn.py:581",
            "tpu_counterpart": "crfp_tpu/ops/pallas/dcn.py::_dcn_bwd_kernel in anchored "
                               f"mode (_bwd_call(geom, ext), _core_op_anchored), {what}",
            # the anchored-mode launches of phase 14(b)'s amp kernel steps
            "launches": atrain_anchored[name],
            "max_abs_err": max(m["max_abs_err"] for m in ms),
            "ms": per_step("ms"), "call_ms": per_step("call_ms"),
            "device_ms": per_step("device_ms"), "plain_ms": per_step("plain_ms"),
            "plain_device_ms": per_step("plain_device_ms"), "bound_ms": per_step("bound_ms"),
            "bound_by": ("bytes" if all(m["bound_by"] == "bytes" for m in on_path)
                         else "operations"),
            "library_ms": per_step("library_ms"),
            "library_device_ms": per_step("library_device_ms"),
            "clamp_ms": per_step("clamp_ms"), "clamp_device_ms": per_step("clamp_device_ms"),
            "per_unit_of": atrain, "modes": ms,
        })
    # the general routes of A, D and E (phase 15), entries of their own: the
    # TPU kernels' every width; per unit of each one's main path at mid 24
    for name, base, src, replaces, unit, path in (
            ("dcn_fwd_general", "dcn_fwd",
             "crfp_torch/csrc/dcn_fwd.cu + common.cuh::dcn_tiles_general",
             "crfp_tpu/ops/pallas/dcn.py:59",
             "main-path calls per steady frame of the mid-24 serving slice (1080p, warp "
             "720^2, windows 8/32), bf16 inputs", "serving mid 24 bf16"),
            ("dcn_bwd_general", "dcn_bwd", "crfp_torch/csrc/dcn_bwd.cu (crfp_dcn_bwd_general)",
             "crfp_tpu/ops/pallas/dcn.py:219",
             "main-path calls per amp train step at mid 24 (B 2, T 7, GT 192, windows 8/32), "
             "bf16 inputs", "amp step mid 24"),
            ("dcn_fused_general", "dcn_fused",
             "crfp_torch/csrc/dcn_fused.cu + common.cuh::dcn_tiles_general",
             "crfp_tpu/ops/pallas/dcn.py:1468",
             "main-path calls per steady DEPLOY frame of the mid-24 gate runner (bf16, windows "
             "8/32, dcn_fused)", "gate DEPLOY mid 24 bf16")):
        ms = [m for m in modes15 if m["kernel"] == name]
        on_path = [m for m in ms if m["calls"] > 0]

        def per_call(key, on_path=on_path):
            if any(m[key] is None for m in on_path):
                return None
            return sum(m[key] * m["calls"] for m in on_path)

        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "tpu_counterpart": f"{replaces.split(':')[0]} at every width the TPU kernel takes "
                               "(any C % G == 0, O, kh x kw), the flags' other widths",
            # the general-route launches of phase 15(b)'s run of this path
            "launches": width_general[path][base],
            "max_abs_err": max(m["max_abs_err"] for m in ms),
            "ms": per_call("ms"), "call_ms": per_call("call_ms"),
            "device_ms": per_call("device_ms"), "plain_ms": per_call("plain_ms"),
            "plain_device_ms": per_call("plain_device_ms"), "bound_ms": per_call("bound_ms"),
            "bound_by": ("bytes" if all(m["bound_by"] == "bytes" for m in on_path)
                         else "operations"),
            "library_ms": None, "library_device_ms": None,
            "per_unit_of": unit, "modes": ms,
        })
    # A's and D's per-tap anchored modes (phase 16), entries of their own: the
    # TPU's :493 and :581 in per-tap anchored mode; per call at mid 32 in bf16
    for name, src, replaces, what, unit in (
            ("dcn_fwd_tap_anchored", "crfp_torch/csrc/dcn_fwd.cu + common.cuh (ProA)",
             "crfp_tpu/ops/pallas/dcn.py:493",
             "crfp_tpu/ops/pallas/dcn.py::_dcn_kernel in anchored mode, per-tap",
             "main-path calls per call of a per-tap anchored stage at mid 32 (1,32,180,180), "
             "G 8, D 8, bf16"),
            ("dcn_bwd_tap_anchored", "crfp_torch/csrc/dcn_bwd.cu",
             "crfp_tpu/ops/pallas/dcn.py:581",
             "crfp_tpu/ops/pallas/dcn.py::_dcn_bwd_kernel in anchored mode (_core_op_anchored), "
             "per-tap", "main-path calls per backward of a per-tap anchored stage at mid 32 "
             "(2,32,48,48), G 8, D 8, the training grid, bf16")):
        ms = [m for m in modes16 if m["kernel"] == name]
        on_path = [m for m in ms if m["calls"] > 0]

        def per_call16(key, on_path=on_path):
            if any(m.get(key) is None for m in on_path):
                return None
            return sum(m[key] * m["calls"] for m in on_path)

        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "tpu_counterpart": what,
            # the per-tap anchored launches of phase 16(c)'s steps of the stage
            "launches": tap_launches[name.split("_tap")[0]],
            "max_abs_err": max(m["max_abs_err"] for m in ms),
            "ms": per_call16("ms"), "call_ms": per_call16("call_ms"),
            "device_ms": per_call16("device_ms"), "plain_ms": per_call16("plain_ms"),
            "plain_device_ms": per_call16("plain_device_ms"),
            "bound_ms": per_call16("bound_ms"),
            "bound_by": ("bytes" if all(m["bound_by"] == "bytes" for m in on_path)
                         else "operations"),
            "library_ms": None, "library_device_ms": None,
            "clamp_ms": per_call16("clamp_ms"), "clamp_device_ms": per_call16("clamp_device_ms"),
            "per_unit_of": unit, "modes": ms,
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
