"""Procedural structured-content corpus: the clips the v18 recipe of record
trained on (checkpoints/v18_mid32_struct_curve.json).

A copy of the corpus half of crfp_tpu/data/procedural.py (numpy, scipy and
Pillow; the port imports nothing of the JAX package): ``make_canvas``,
``make_clip``, ``make_clip_pool`` and ``lr_box``, unchanged, and
``clip_sample``, the sample dict of one clip that the REDS-shaped
``TrainSet``/``EvalSet``/``TestSet`` of that module return (:236-260),
with ``LR_sr`` only for a ``y_only`` model (:270). Those dataset classes
serve the JAX package's ``main.py`` and are not copied.

- **dead leaves**: overlapping random disks/rectangles with radii drawn
  from a power-law (the classic natural-image-statistics model) — sharp
  scale-invariant edges at every scale;
- **text glyphs**: random alphanumeric strings (DejaVuSans when
  available, PIL default otherwise) at HR sizes 16-64 px — the canonical
  "fovea recovers it, LR cannot" content;
- **gratings / checkerboards** at mixed frequencies, including beyond
  the LR Nyquist (recoverable only via the fovea patch or temporal
  subpixel aggregation);
- **filtered noise** background for low-frequency fill.

Motion: per-clip background velocity up to ~3 LR px/frame (the D=8
trunk-window displacement budget at the 2x alignment resolution), plus —
in most clips — an independently moving foreground layer (a disk- or
box-masked patch of a second canvas), giving mixed per-clip velocities
and occlusion/disocclusion boundaries. Offsets are integer HR pixels so
ground truth needs no resampling, while LR frames still sample 1/8-px
subpixel phases (scale 8) — the signal multi-frame aggregation needs.

The canvases are drawn with Pillow. Where Pillow is missing,
``crfp_torch.tools.train_procedural`` raises before it draws and names the
clip-pool cache that can stand in for the corpus.
"""

from __future__ import annotations

import numpy as np

_GLYPHS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"


def _font(size: int):
    import PIL.ImageFont

    try:  # matplotlib ships DejaVuSans; keeps glyph shapes stable across hosts
        import matplotlib

        path = matplotlib.get_data_path() + "/fonts/ttf/DejaVuSans-Bold.ttf"
        return PIL.ImageFont.truetype(path, size)
    except Exception:
        return PIL.ImageFont.load_default(size=size)


def _noise_background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    from scipy import ndimage

    base = rng.uniform(0, 1, (h, w, 3))
    sigma = float(rng.uniform(3.0, 8.0))
    base = ndimage.gaussian_filter(base, (sigma, sigma, 0))
    lo, hi = base.min(), base.max()
    # moderate contrast: the background is fill, not unrecoverable grain —
    # the recoverable high frequencies come from leaves/glyphs/gratings
    return 0.2 + 0.6 * (base - lo) / (hi - lo + 1e-9)


def make_canvas(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A structured HR canvas, float32 (h, w, 3) in [0, 1]."""
    import PIL.Image
    import PIL.ImageDraw

    canvas = _noise_background(rng, h, w)
    img = PIL.Image.fromarray((canvas * 255).astype(np.uint8))
    draw = PIL.ImageDraw.Draw(img)

    # dead leaves: power-law radii (r ~ u^-1/2, clipped) — denser small
    # leaves with occasional large occluders
    n_leaves = max(8, (h * w) // 6000)
    for _ in range(n_leaves):
        r = float(np.clip(6.0 / np.sqrt(rng.uniform(0.003, 1.0)), 4, min(h, w) / 5))
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        box = (cx - r, cy - r, cx + r, cy + r)
        if rng.random() < 0.5:
            draw.ellipse(box, fill=color)
        else:
            draw.rectangle(box, fill=color)

    # grating / checkerboard patches: frequencies from 4 px/cycle (below
    # the 8x-LR Nyquist of 16 px/cycle) to 48 px/cycle
    arr = np.asarray(img).astype(np.float32) / 255.0
    for _ in range(int(rng.integers(1, 4))):
        ph = int(rng.integers(h // 8, h // 3))
        pw = int(rng.integers(w // 8, w // 3))
        y0 = int(rng.integers(0, h - ph))
        x0 = int(rng.integers(0, w - pw))
        yy, xx = np.mgrid[0:ph, 0:pw].astype(np.float32)
        ang = rng.uniform(0, np.pi)
        period = float(rng.uniform(4, 48))
        phase = (np.cos(ang) * yy + np.sin(ang) * xx) * (2 * np.pi / period)
        if rng.random() < 0.5:
            pat = 0.5 + 0.5 * np.sin(phase)
        else:  # checkerboard
            pat = ((yy // (period / 2)).astype(int) + (xx // (period / 2)).astype(int)) % 2
        c0 = rng.uniform(0, 0.4, 3)
        c1 = rng.uniform(0.6, 1.0, 3)
        arr[y0 : y0 + ph, x0 : x0 + pw] = (
            c0 + (c1 - c0) * pat[..., None]
        ).astype(np.float32)

    # text glyphs on top
    img = PIL.Image.fromarray((arr * 255).round().astype(np.uint8))
    draw = PIL.ImageDraw.Draw(img)
    n_text = int(rng.integers(4, 12)) + (h * w) // 40000  # area-scaled
    for _ in range(n_text):
        size = int(rng.integers(16, 64))
        n_ch = int(rng.integers(3, 9))
        text = "".join(rng.choice(list(_GLYPHS), n_ch))
        y0 = int(rng.integers(0, max(1, h - size)))
        x0 = int(rng.integers(0, max(1, w - size * n_ch)))
        col = (0, 0, 0) if rng.random() < 0.5 else (255, 255, 255)
        draw.text((x0, y0), text, font=_font(size), fill=col)

    return np.asarray(img).astype(np.float32) / 255.0


def _fg_mask(rng: np.random.Generator, s: int) -> np.ndarray:
    """(s, s, 1) binary alpha: a disk or box covering ~25-60% of the patch."""
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    if rng.random() < 0.5:
        r = s * rng.uniform(0.28, 0.44)
        m = ((yy - s / 2) ** 2 + (xx - s / 2) ** 2) < r * r
    else:
        my, mx = s * rng.uniform(0.15, 0.3), s * rng.uniform(0.15, 0.3)
        m = (yy >= my) & (yy < s - my) & (xx >= mx) & (xx < s - mx)
    return m.astype(np.float32)[..., None]


def make_clip(
    rng: np.random.Generator,
    t: int,
    gt: int,
    scale: int = 8,
    v_max: float = 3.0,
    layered: bool = True,
) -> np.ndarray:
    """One HR clip (t, gt, gt, 3), float32 [0, 1].

    Background translates at a per-clip velocity |v| <= v_max LR px/frame;
    with probability 0.75 (``layered``) a foreground patch moves at its
    own independent velocity over it (occlusion boundaries).
    """
    pad = int(np.ceil(t * v_max * scale)) + 8
    big = make_canvas(rng, gt + pad, gt + pad)

    ang = rng.uniform(0, 2 * np.pi)
    speed = rng.uniform(0.25, v_max)
    vb = np.array([np.cos(ang), np.sin(ang)]) * speed * scale  # HR px/frame

    use_fg = layered and rng.random() < 0.75
    if use_fg:
        fs = int(gt * rng.uniform(0.3, 0.5))
        fg = make_canvas(rng, fs, fs)
        fgm = _fg_mask(rng, fs)
        ang_f = rng.uniform(0, 2 * np.pi)
        speed_f = rng.uniform(0.25, v_max)
        vf = np.array([np.cos(ang_f), np.sin(ang_f)]) * speed_f * scale
        # start position chosen so the patch stays inside the frame
        lo = np.maximum(0, -vf * (t - 1))
        hi = np.minimum(gt - fs, gt - fs - vf * (t - 1))
        p0 = np.array([rng.uniform(lo[0], max(hi[0], lo[0] + 1e-6)),
                       rng.uniform(lo[1], max(hi[1], lo[1] + 1e-6))])

    frames = []
    for k in range(t):
        y0 = int(round(pad / 2 + k * vb[0]))
        x0 = int(round(pad / 2 + k * vb[1]))
        y0 = int(np.clip(y0, 0, pad))
        x0 = int(np.clip(x0, 0, pad))
        frame = big[y0 : y0 + gt, x0 : x0 + gt].copy()
        if use_fg:
            fy = int(np.clip(round(p0[0] + k * vf[0]), 0, gt - fs))
            fx = int(np.clip(round(p0[1] + k * vf[1]), 0, gt - fs))
            reg = frame[fy : fy + fs, fx : fx + fs]
            frame[fy : fy + fs, fx : fx + fs] = fgm * fg + (1 - fgm) * reg
        frames.append(frame)
    return np.stack(frames).astype(np.float32)


def make_clip_pool(
    n_clips: int, t: int, gt: int, seed: int, scale: int = 8, v_max: float = 3.0
) -> list[np.ndarray]:
    """Pre-generate a pool of structured clips (train_procedural's corpus)."""
    rng = np.random.default_rng(seed)
    return [make_clip(rng, t, gt, scale, v_max) for _ in range(n_clips)]


def lr_box(hr: np.ndarray, scale: int = 8) -> np.ndarray:
    """(T, H, W, 3) -> (T, H/s, W/s, 3) box-mean downsample (the corpus'
    LR formation model, shared by training and every procedural eval)."""
    t, h, w, c = hr.shape
    return hr.reshape(t, h // scale, scale, w // scale, scale, c).mean((2, 4))


def bicubic_lr(lr: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(T, h, w, 3) LR in [0, 1] -> (T, oh, ow, 3) float32 ``LR_sr``: its
    8-bit frames resized bicubic with Pillow
    (crfp_tpu/data/reds.py::_bicubic_upsample, Pillow branch), over 255."""
    import PIL.Image

    frames = (lr * 255).round().astype(np.uint8)
    return np.stack([
        np.array(PIL.Image.fromarray(im).resize((ow, oh), PIL.Image.BICUBIC))
        for im in frames]).astype(np.float32) / 255.0


def clip_sample(hr: np.ndarray, fv_size: int, scan: str = "Evenscan",
                rng: np.random.Generator | None = None, *, scale: int = 8,
                y_only: bool = False) -> dict[str, np.ndarray]:
    """The sample of the clip ``hr`` (T, H, W, 3) as the JAX package's
    procedural datasets give it (crfp_tpu/data/procedural.py:236-260):
    ``LR`` its box mean, ``HR``, ``Ref`` / ``Ref_sp`` the fovea frames and
    masks of ``fovea_generator(method=scan)`` (``rng`` for Nanascan), and
    with ``y_only`` also ``LR_sr``, the bicubic x8 upsample of the 8-bit LR
    frames, whose UV the ``y_only`` evaluation puts beside the model's Y."""
    from crfp_torch.data.fovea import fovea_generator

    _, h, w, _ = hr.shape
    lr = lr_box(hr, scale).astype(np.float32)
    ref, ref_sp, _ = fovea_generator(hr, method=scan, fv_hw=(fv_size, fv_size),
                                     rng=rng if scan == "Nanascan" else None)
    sample = {"LR": lr, "HR": hr, "Ref": ref.astype(np.float32),
              "Ref_sp": ref_sp.astype(np.float32)}
    if y_only:
        sample["LR_sr"] = bicubic_lr(lr, h, w)
    return sample
