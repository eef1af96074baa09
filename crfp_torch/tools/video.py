"""Video, frame and GIF tools, and Middlebury flow rendering
(crfp_tpu/tools/video.py; root ``gen_video.py``, ``png2mp4.py`` and
``gif_combine.py``).

- ``video_to_frames``: mp4 -> PNG frames, centre-cropped to a target size
  (the reference's gen_video.py);
- ``frames_to_mp4``: PNG frames -> mp4 at a given fps (png2mp4.py);
- ``frames_to_gif`` / ``combine_gifs``: GIF export of the demo paths and
  GIFs side by side (gif_combine.py), written and read with Pillow;
- ``result_comp``: a left/right comparison frame with a white separator;
- ``flow_to_color``: the Middlebury colour-wheel flow rendering.

The two mp4 functions import OpenCV (``cv2``) when called, as the JAX
module does.

    python -m crfp_torch.tools.video to_frames VIDEO OUT_DIR [--crop_h 1080] [--crop_w 1920]
    python -m crfp_torch.tools.video to_mp4 FRAME_DIR OUT [--fps 20]
    python -m crfp_torch.tools.video combine_gifs A.gif B.gif ... --out OUT [--fps 7] [--axis 1]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def video_to_frames(video_path: str, out_dir: str,
                    crop_hw: tuple[int, int] | None = (1080, 1920)) -> int:
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if crop_hw is not None:
            h, w = frame.shape[:2]
            ch, cw = crop_hw
            y0 = max((h - ch) // 2, 0)
            x0 = max((w - cw) // 2, 0)
            frame = frame[y0:y0 + ch, x0:x0 + cw]
        cv2.imwrite(os.path.join(out_dir, f"{n:08d}.png"), frame)
        n += 1
    cap.release()
    return n


def frames_to_mp4(frame_dir: str, out_path: str, fps: int = 20) -> int:
    import cv2

    files = sorted(os.path.join(frame_dir, f) for f in os.listdir(frame_dir)
                   if f.endswith(".png"))
    if not files:
        raise FileNotFoundError(f"no .png frames in {frame_dir}")
    first = cv2.imread(files[0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in files:
        writer.write(cv2.imread(f))
    writer.release()
    return len(files)


def frames_to_gif(frames, out_path: str, fps: int = 7) -> None:
    """frames: list of (H, W, 3) uint8 RGB arrays."""
    import PIL.Image

    imgs = [PIL.Image.fromarray(f) for f in frames]
    imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                 duration=int(round(1000 / fps)), loop=0)


def read_gif(path: str) -> list[np.ndarray]:
    """Every frame of a GIF as an (H, W, 3) uint8 RGB array."""
    import PIL.Image
    import PIL.ImageSequence

    with PIL.Image.open(path) as im:
        return [np.array(f.convert("RGB")) for f in PIL.ImageSequence.Iterator(im)]


def combine_gifs(paths: list[str], out_path: str, fps: int = 7, axis: int = 1) -> None:
    """Concatenate GIFs side by side (``axis`` 1) or stacked (0), frame by
    frame over the shortest, each row cut to the smallest height."""
    frames = [read_gif(p) for p in paths]
    n = min(len(f) for f in frames)
    out = []
    for i in range(n):
        row = [f[i] for f in frames]
        hmin = min(r.shape[0] for r in row)
        out.append(np.concatenate([r[:hmin] for r in row], axis=axis))
    frames_to_gif(out, out_path, fps)


def result_comp(left: np.ndarray, right: np.ndarray, split_x: int) -> np.ndarray:
    """Side-by-side comparison frame: ``left`` up to column ``split_x``,
    ``right`` after it, a white separator column between. (H, W, 3) uint8."""
    out = right.copy()
    out[:, :split_x] = left[:, :split_x]
    out[:, split_x] = 255
    return out


def _make_colorwheel() -> np.ndarray:
    """Baker et al. ICCV'07 colour wheel."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_color(flow: np.ndarray, clip_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow (dx, dy) -> (H, W, 3) uint8 rendering."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u**2 + v**2)

    wheel = _make_colorwheel()
    ncols = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((*u.shape, 3), np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., i] = np.floor(255 * col)
    return img


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="video, frame and GIF tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("to_frames", help="mp4 -> centre-cropped PNG frames (gen_video.py)")
    a.add_argument("video")
    a.add_argument("out_dir")
    a.add_argument("--crop_h", type=int, default=1080)
    a.add_argument("--crop_w", type=int, default=1920)
    a = sub.add_parser("to_mp4", help="PNG frames -> mp4 (png2mp4.py)")
    a.add_argument("frame_dir")
    a.add_argument("out")
    a.add_argument("--fps", type=int, default=20)
    a = sub.add_parser("combine_gifs", help="GIFs side by side (gif_combine.py)")
    a.add_argument("gifs", nargs="+")
    a.add_argument("--out", required=True)
    a.add_argument("--fps", type=int, default=7)
    a.add_argument("--axis", type=int, default=1)
    return p


def main(argv=None) -> None:
    a = build_parser().parse_args(argv)
    if a.cmd == "to_frames":
        n = video_to_frames(a.video, a.out_dir, (a.crop_h, a.crop_w))
        print(f"wrote {n} frames to {a.out_dir}")
    elif a.cmd == "to_mp4":
        n = frames_to_mp4(a.frame_dir, a.out, a.fps)
        print(f"wrote {n} frames to {a.out}")
    else:
        combine_gifs(a.gifs, a.out, a.fps, a.axis)
        print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
