"""Headline benchmark: the port's counterpart of the JAX package's root
``bench.py``, one JSON line.

    python -m crfp_torch.tools.bench

Root ``bench.py``'s three protocols of ``CRFPRuntimeV18``, each a fused
chain of t=5 frames a rep (``crfp_torch.bench.runtime``):
- the reference's runtime latency protocol: 1080p output (LR 135x240),
  fovea 96^2, warp_size 720x720, 30 reps after 10 warm-up;
- BASELINE.md's row: 720p with no ROI crop (warp 720x1280), 20 reps after 5;
- full-frame 1080p (warp 1080x1920), 15 reps after 5.

The model runs ``_DEPLOY``: mid 32, windows 8 / 32, bfloat16 weights and
activations (f32 accumulation in the kernels). The JAX ``_DEPLOY`` also
sets ``hr_s2d``, ``emit_s2d`` and ``dcn_anchor``: the first two are TPU
layouts of the same math, and anchored windows sample other pixels than
the plain clamp, which the port does not carry; the line's ``config``
says so. The metric names are root ``bench.py``'s; ``unit`` is
``frames/sec/gpu``, ``vs_baseline`` is frames/sec over the 30 fps
real-time bar (BASELINE.md), and ``device`` gives the card's name and
power limit. Runs on the card only.
"""

from __future__ import annotations

import argparse
import json

_DEPLOY = dict(mid_channels=32, t=5, dcn_window=8, dcn_window_hr=32, bf16=True, fused=True)
CONFIG = ("_DEPLOY: mid 32, t 5, windows 8/32, bf16, fused; no dcn_anchor (anchored "
          "windows are not carried by the port), no hr_s2d/emit_s2d (TPU layouts)")
# (metric, preset, warp, reps, warm-up): root bench.py's protocols
PROTOCOLS = (
    ("1080p_8x_foveated_sr_runtime_warp720", "1080p", (720, 720), 30, 10),
    ("720p_8x_foveated_sr_streaming_fullframe", "720p", (720, 1280), 20, 5),
    ("1080p_8x_foveated_sr_streaming_fullframe", "1080p", (1080, 1920), 15, 5),
)


def run(protocols=PROTOCOLS) -> dict:
    """The JSON line's object, each protocol run in order."""
    from crfp_torch.bench import card_line
    from crfp_torch.bench.runtime import run_runtime_bench

    entries = []
    for metric, preset, warp, reps, warm in protocols:
        res = run_runtime_bench(preset=preset, warp_size=warp, repeat_time=reps,
                                warm_up=warm, **_DEPLOY)
        fps = res.frames_per_sec
        entries.append({"metric": metric, "value": round(fps, 3), "unit": "frames/sec/gpu",
                        "vs_baseline": round(fps / 30.0, 3)})
    head, *also = entries
    return {**head, "also": also, "device": card_line(), "config": CONFIG}


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    line = run()
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
