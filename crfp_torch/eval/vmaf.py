"""VMAF perceptual scoring (crfp_tpu/eval/vmaf.py; test_video_quality.sh
parity).

The reference shells out to ffmpeg's libvmaf after upscaling the SR video
to 1280x720 (the reference's test_video_quality.sh:17-23). This is the
port's own copy of the JAX package's harness: the same ffmpeg command line
and the same score pattern. It needs an ``ffmpeg`` with libvmaf on the
``PATH`` and raises a clear error where there is none, rather than
skipping; no kernel and no device are involved.
"""

from __future__ import annotations

import re
import shutil
import subprocess


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def vmaf_command(sr_video: str, gt_video: str, width: int = 1280, height: int = 720,
                 fps: int = 24) -> list[str]:
    """The ffmpeg argv: both videos scaled bicubically to ``width`` x
    ``height`` at ``fps``, then libvmaf of sr against gt."""
    return [
        "ffmpeg", "-i", sr_video, "-i", gt_video,
        "-filter_complex",
        f"[0:v]scale={width}:{height}:flags=bicubic,fps={fps}[sr];"
        f"[1:v]scale={width}:{height}:flags=bicubic,fps={fps}[gt];"
        f"[sr][gt]libvmaf",
        "-f", "null", "-",
    ]


def vmaf_score(sr_video: str, gt_video: str, width: int = 1280, height: int = 720,
               fps: int = 24) -> float:
    """Returns the pooled VMAF mean of sr vs gt, parsed from ffmpeg's
    standard error (``VMAF score: x`` or ``VMAF score=x``)."""
    if not ffmpeg_available():
        raise RuntimeError(
            "ffmpeg (with libvmaf) is required for VMAF scoring but is not "
            "installed in this environment. Install ffmpeg or run "
            "test_video_quality.sh on a machine that has it."
        )
    proc = subprocess.run(vmaf_command(sr_video, gt_video, width, height, fps),
                          capture_output=True, text=True)
    m = re.search(r"VMAF score[:=]\s*([0-9.]+)", proc.stderr)
    if not m:
        raise RuntimeError(f"could not parse VMAF score from ffmpeg output:\n{proc.stderr[-2000:]}")
    return float(m.group(1))
