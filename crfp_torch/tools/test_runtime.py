"""Latency benchmark entry point: the port's counterpart of the JAX
package's root ``test_runtime.py`` (the reference's test_runtime.py).

    python -m crfp_torch.tools.test_runtime [--preset 1080p|720p|512]
        [--warp 720] [--warp_w W] [--mid 32] [--reps 30] [--warmup 10]
        [--t 5] [--dcn_window D] [--dcn_window_hr D] [--bf16] [--fused]
        [--model_path CKPT] [--cpu]

The root script's flags, names and defaults (``crfp_torch.bench.runtime``
does the timing): without ``--fused`` each rep times flow, encoders and
step apart, with it one chain of frames. ``--model_path`` takes any
checkpoint ``crfp_torch.utils.params_io.load_params`` reads (``.npz``, a
reference ``.pt``, a port checkpoint directory), adapted from the batch
trunk onto the runtime trunk. ``--hr_s2d``, ``--lv3_s2d`` and
``--emit_s2d`` are TPU layouts of the same math: accepted, and logged as
having no effect. ``--dcn_anchor`` raises (``crfp_torch.config``). Runs on
the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="streaming latency of CRFPRuntimeV18")
    p.add_argument("--preset", default="1080p", choices=["1080p", "720p", "512"])
    p.add_argument("--warp", type=int, default=720)
    p.add_argument("--warp_w", type=int, default=None)
    p.add_argument("--mid", type=int, default=32)
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--t", type=int, default=5)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--dcn_window", type=int, default=None)
    p.add_argument("--dcn_window_hr", type=int, default=None)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--hr_s2d", action="store_true")
    p.add_argument("--lv3_s2d", action="store_true")
    p.add_argument("--dcn_anchor", action="store_true")
    p.add_argument("--emit_s2d", action="store_true")
    p.add_argument("--fused", action="store_true",
                   help="one chain of frames timed at its end (the deployment number) "
                        "instead of flow, encoders and step apart")
    p.add_argument("--model_path", default=None,
                   help="run with trained weights (any checkpoint load_params reads; "
                        "the batch-trunk checkpoint is adapted onto the runtime trunk) "
                        "instead of the seeded init")
    return p


def main(argv=None):
    from crfp_torch.bench.runtime import run_runtime_bench
    from crfp_torch.config import check_tpu_flags

    args = build_parser().parse_args(argv)
    check_tpu_flags(args)

    res = run_runtime_bench(
        preset=args.preset,
        warp_size=(args.warp, args.warp_w or args.warp),
        mid_channels=args.mid,
        t=args.t,
        repeat_time=args.reps,
        warm_up=args.warmup,
        dcn_window=args.dcn_window,
        dcn_window_hr=args.dcn_window_hr,
        bf16=args.bf16,
        params_path=args.model_path,
        fused=args.fused,
        device="cpu" if args.cpu else "cuda",
    )
    print(res)
    return res


if __name__ == "__main__":
    main()
