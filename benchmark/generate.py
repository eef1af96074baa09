"""The benchmark's one traffic generator: it reads a mix's parameters
(``benchmark/traffic/<mix>.json``) and makes its inputs on the device from
the run's seed.

Every frame is filtered noise, as ``crfp_torch/bench/train.py::
noise_clip_pool`` makes it (a copy of its method, run on the device): a
canvas of Gaussian noise box-filtered twice at a coarse radius (6-15 px)
and a fine one (1-2 px, weight 0.35), normalised to [0, 1] and translated
by a constant velocity of at most ``max_motion_lr_px`` LR pixels a frame,
in whole HR pixels. LR frames are the 8 x 8 box means of the HR frames
(``tools/train_procedural.py::make_batch``).

- ``kind: stream``: ``viewers`` streams served as one batch. For each
  viewer a pool of ``pool_frames`` consecutive frames of its own moving
  canvas; the streams play their pools forwards and back in step (so motion
  stays continuous), each frame's fovea the top-left ``fovea_hw`` crop of
  its HR frame, where the model blends it.
- ``kind: train``: ``pool_batches`` batches of ``batch`` clips of
  ``frames`` frames at ``gt`` x ``gt`` HR, every clip its own canvas and
  velocity, and each frame's fovea mask a ``fovea`` x ``fovea`` square that
  walks a seeded straight path (a stand-in for the reference's gaze scans:
  the blend is a full-frame multiply whatever the square's place).

Each seed draws the same sizes, only other pixels and velocities.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def _blur(a: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Box filter of radius ``r`` along ``dim`` (edge-padded), by cumsum."""
    n = a.shape[dim]
    idx = torch.cat([torch.zeros(r + 1, dtype=torch.long), torch.arange(n),
                     torch.full((r,), n - 1, dtype=torch.long)]).to(a.device)
    c = torch.cumsum(a.index_select(dim, idx), dim=dim)
    hi = c.narrow(dim, 2 * r + 1, n)
    lo = c.narrow(dim, 0, n)
    return (hi - lo) / (2 * r + 1)


def noise_canvases(n: int, size: tuple[int, int], gen: torch.Generator, device) -> torch.Tensor:
    """``n`` canvases (n, 3, H, W) float32 in [0, 1]: noise filtered at a
    coarse and a fine radius."""
    h, w = size
    radii = torch.randint(6, 16, (n,), generator=gen, device=device).tolist()
    fine = torch.randint(1, 3, (n,), generator=gen, device=device).tolist()
    out = torch.zeros(n, 3, h, w, device=device)
    for i in range(n):
        for r, amp in ((radii[i], 1.0), (fine[i], 0.35)):
            a = torch.randn(3, h, w, generator=gen, device=device)
            for _ in range(2):
                a = _blur(_blur(a, r, 1), r, 2)
            out[i] += amp * a / a.std()
    lo = out.amin(dim=(1, 2, 3), keepdim=True)
    hi = out.amax(dim=(1, 2, 3), keepdim=True)
    return (out - lo) / (hi - lo)


def _velocities(n: int, v_max: float, scale: int, gen, device) -> torch.Tensor:
    return (torch.rand(n, 2, generator=gen, device=device) * 2 - 1) * v_max * scale


def stream_pool(mix: dict, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    """The streams' frames: 'lr' (P, V, h, w, 3) and 'fv' (P, V, fh, fw, 3),
    NHWC in ``dtype``, P = ``pool_frames``, V = ``viewers``: ``[p]`` is the
    batch of every viewer's ``p``-th frame."""
    gen = _gen(seed, 1, device)
    s = mix["scale"]
    h, w = mix["lr_hw"]
    hh, ww = h * s, w * s
    p, n = mix["pool_frames"], mix["viewers"]
    fh, fw = mix["fovea_hw"]
    pad = int(math.ceil((p - 1) * mix["max_motion_lr_px"] * s)) + 2
    canvases = noise_canvases(n, (hh + 2 * pad, ww + 2 * pad), gen, device)
    vel = _velocities(n, mix["max_motion_lr_px"], s, gen, device).tolist()
    lrs = torch.empty(p, n, 3, h, w, device=device)
    fvs = torch.empty(p, n, 3, fh, fw, device=device)
    for k in range(p):
        for v in range(n):
            y0, x0 = (pad + round(k * vel[v][0]), pad + round(k * vel[v][1]))
            hr = canvases[v, :, y0:y0 + hh, x0:x0 + ww]
            lrs[k, v] = F.avg_pool2d(hr[None], s)[0]
            fvs[k, v] = hr[:, :fh, :fw]
    as_nhwc = lambda t: t.permute(0, 1, 3, 4, 2).contiguous().to(dtype)  # noqa: E731
    return {"lr": as_nhwc(lrs), "fv": as_nhwc(fvs)}


def stream_index(i: int, pool: int) -> int:
    """The pool frame of a stream's ``i``-th frame: forwards, then back."""
    period = 2 * pool - 2
    j = i % period
    return j if j < pool else period - j


def train_pool(mix: dict, seed: int, device) -> list[dict[str, torch.Tensor]]:
    """``pool_batches`` batches of 'lr' (B, T, h, w, 3), 'hr' = 'fv' (B, T,
    gt, gt, 3) and 'mk' (B, T, gt, gt, 1), float32 NHWC on ``device``;
    every clip of every batch its own."""
    gen = _gen(seed, 2, device)
    s, b, t, gt, fv = mix["scale"], mix["batch"], mix["frames"], mix["gt"], mix["fovea"]
    n = mix["pool_batches"] * b
    pad = int(math.ceil((t - 1) * mix["max_motion_lr_px"] * s)) + 2
    canvases = noise_canvases(n, (gt + 2 * pad, gt + 2 * pad), gen, device)
    vel = _velocities(n, mix["max_motion_lr_px"], s, gen, device).tolist()
    clips = torch.empty(n, t, 3, gt, gt, device=device)
    for i in range(n):
        for k in range(t):
            y0, x0 = pad + round(k * vel[i][0]), pad + round(k * vel[i][1])
            clips[i, k] = canvases[i, :, y0:y0 + gt, x0:x0 + gt]
    del canvases
    # fovea squares: a seeded start and a straight walk, kept inside the frame
    start = torch.rand(n, 1, 2, generator=gen, device=device) * (gt - fv)
    step = (torch.rand(n, 1, 2, generator=gen, device=device) * 2 - 1) * (gt - fv) / t
    ks = torch.arange(t, device=device).view(1, t, 1)
    pos = (start + ks * step).round().clamp(0, gt - fv)  # (n, t, 2) top-left (y, x)
    rows = torch.arange(gt, device=device).view(1, 1, gt, 1)
    cols = torch.arange(gt, device=device).view(1, 1, 1, gt)
    py, px = pos[..., 0].view(n, t, 1, 1), pos[..., 1].view(n, t, 1, 1)
    mk = ((rows >= py) & (rows < py + fv) & (cols >= px) & (cols < px + fv)).float()
    hr = clips.permute(0, 1, 3, 4, 2).contiguous()
    lr = F.avg_pool2d(clips.reshape(n * t, 3, gt, gt), s).reshape(n, t, 3, gt // s, gt // s)
    lr = lr.permute(0, 1, 3, 4, 2).contiguous()
    mk = mk[..., None]
    return [{"lr": lr[j * b:(j + 1) * b], "hr": hr[j * b:(j + 1) * b],
             "fv": hr[j * b:(j + 1) * b], "mk": mk[j * b:(j + 1) * b]}
            for j in range(mix["pool_batches"])]
