"""Kernels F (SSIM map) and C (frame emission) at the main paths' shapes.

    python -m crfp_torch.bench.emit_ssim

F: for the training step's RGB and luma calls and the gate's frame, the
device time of the kernel on three layouts of the same values (both
operands NCHW-contiguous, both NCHW views of NHWC memory, and the training
step's: x an NHWC view of NCHW memory as the model returns its frames, y
NHWC), which must give the same bits; then the whole masked SSIM on the
layouts its callers pass (the training step's, the gate's NHWC frames), as
``masked_ssim`` runs it (both images read in place) and as it ran before
(both copied to NCHW-contiguous first, :func:`masked_ssim_copies`; a copy
of an image that already is NCHW-contiguous costs nothing).

C: at 1080p, bf16 and f32, the row route (the main path: aligned y) and
the pixel route on the same values (y read through a view offset by one
element, which :func:`crfp_torch.ops.cuda.emit.emit_plan` sends there);
the two routes must give the same bits.

Device time: 20 calls captured in one CUDA graph and replayed between two
events, the least of 5 replays, as ``chip_smoke.py`` times them. Ends with
one JSON line. Fails without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from crfp_torch.bench.dcn_tiles import device_ms
from crfp_torch.ops.cuda import emit, ssim

# (name, (n, c, h, w)): F's calls on the main paths
SSIM_SHAPES = [
    ("train RGB", (14, 3, 192, 192)),
    ("train Y", (14, 1, 192, 192)),
    ("gate", (1, 3, 720, 1280)),
]
EMIT_SHAPE = (1, 3, 1080, 1920)  # the serving frame, from LR 135x240
EMIT_LR_HW = (135, 240)


def masked_ssim_copies(sr: torch.Tensor, hr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``crfp_torch.ops.metrics.masked_ssim`` as it ran before kernel F read
    its operands in place: both images copied to NCHW-contiguous first."""
    c = sr.shape[-1]
    smap = ssim.ssim_map(sr.float().permute(0, 3, 1, 2).contiguous(),
                         hr.float().permute(0, 3, 1, 2).contiguous())
    mask = mask.to(smap.dtype).permute(0, 3, 1, 2)
    return (smap * mask).sum() / (mask.sum() * c)


def run_ssim() -> list[dict]:
    from crfp_torch.ops.metrics import masked_ssim

    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, (n, c, h, w) in SSIM_SHAPES:
        # (sr, hr) NCHW-contiguous: white noise in [0, 1] and a noisy copy
        hr = torch.rand(n, c, h, w, generator=gen)
        sr = (hr + 0.1 * torch.randn(n, c, h, w, generator=gen)).clamp(0, 1)
        sr, hr = sr.cuda(), hr.cuda()
        sr_h, hr_h = (t.permute(0, 2, 3, 1).contiguous() for t in (sr, hr))  # NHWC
        views = {"nchw": (sr, hr),
                 "nhwc": (sr_h.permute(0, 3, 1, 2), hr_h.permute(0, 3, 1, 2)),
                 "step": (sr, hr_h.permute(0, 3, 1, 2))}
        want = ssim.ssim_map(sr, hr)
        for layout, (x, y) in views.items():
            got = ssim.ssim_map(x, y)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                sys.exit(f"emit_ssim: F {name} {layout} differs from NCHW operands")
            ms = device_ms(lambda: ssim.ssim_map(x, y))
            rows.append(dict(kernel="ssim", shape=name, layout=layout, device_ms=ms))
            print(f"[ssim] {name:10s} kernel {layout:4s}: device {ms:.4f} ms")
        # the NHWC images its callers pass: the step's frames, the gate's
        caller = "step" if name.startswith("train") else "gate"
        x_nhwc = sr.permute(0, 2, 3, 1) if caller == "step" else sr_h
        mask = torch.ones_like(hr_h[..., :1])
        for route, fn in (("in place", masked_ssim), ("copies", masked_ssim_copies)):
            ms = device_ms(lambda: fn(x_nhwc, hr_h, mask))
            rows.append(dict(kernel="masked_ssim", shape=name, layout=caller, route=route,
                             device_ms=ms))
            print(f"[ssim] {name:10s} masked_ssim, {caller} layout, {route}: device "
                  f"{ms:.4f} ms")
    return rows


def run_emit() -> list[dict]:
    gen = torch.Generator().manual_seed(0)
    n, c, h, w = EMIT_SHAPE
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        y = torch.randn(n, c, h, w, generator=gen).to("cuda", dtype)
        lr = torch.rand(n, c, *EMIT_LR_HW, generator=gen).to("cuda", dtype)
        buf = torch.empty(y.numel() + 1, dtype=dtype, device="cuda")
        y_off = buf[1:].view_as(y)
        y_off.copy_(y)
        want = emit.emit_frame(y, lr)
        for route, y_ in (("row", y), ("pixel", y_off)):
            got = emit.emit_frame(y_, lr)
            torch.cuda.synchronize()
            plan = emit.emit_plan(n, c, h, w, 1, dtype, y_.data_ptr(), got.data_ptr(),
                                  lr.shape[-1])
            if plan.vector != (route == "row") or not torch.equal(got, want):
                sys.exit(f"emit_ssim: C {route} route {dtype}: plan {plan} or bits differ")
            ms = device_ms(lambda: emit.emit_frame(y_, lr))
            rows.append(dict(kernel="emit", dtype=str(dtype).split(".")[-1], route=route,
                             device_ms=ms))
            print(f"[emit] 1080p {rows[-1]['dtype']:8s} {route:5s} route: device {ms:.4f} ms")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("emit_ssim: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}")
    print(json.dumps({"emit_ssim": run_ssim() + run_emit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
