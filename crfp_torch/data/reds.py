"""REDS dataset readers (host side, numpy NHWC; crfp_tpu/data/reds.py).

The reference's REDS readers:
- TrainSet: every REDS train+val clip except held-out {train 000,011,015,020}
  and {val 000,001,006,017}; sliding windows of N_frames; pre-downsampled LR
  from the ``_sharp_BI_x8`` (scale 8) / ``_sharp_BI`` (scale 4) trees;
  PIL-bicubic LR_sr; aligned random crop; Nanascan fovea; /255; paired
  h/v flips p=0.5.
- EvalSet: val clips 000/001/006/017, Evenscan.
- TestSet: train clips 000/011/015/020 (= REDS4), Evenscan.

Samples are dicts of float32 NHWC arrays keyed like the reference
('LR', 'LR_sr', 'HR', 'Ref', 'Ref_sp' [+ 'FV_sp']).
"""

from __future__ import annotations

import os

import numpy as np
import PIL.Image

from crfp_torch.data.fovea import fovea_generator

_TRAIN_HELDOUT = ("000", "011", "015", "020")
_VAL_HELDOUT = ("000", "001", "006", "017")


def _lr_root(dataset_dir: str, scale: int) -> str:
    if scale == 8:
        return dataset_dir.replace("_sharp", "_sharp_BI_x8")
    if scale == 4:
        return dataset_dir.replace("_sharp", "_sharp_BI")
    raise ValueError(f"unsupported scale {scale}")


def _load(path: str) -> np.ndarray:
    return np.array(PIL.Image.open(path))


def _windows(dir_list: list[str], n_frames: int) -> list[list[str]]:
    out = []
    for d in dir_list:
        files = sorted(os.listdir(d))
        for i in range(0, len(files) - n_frames + 1):
            out.append([os.path.join(d, f) for f in files[i : i + n_frames]])
    return out


def _to_float(stacked: np.ndarray) -> np.ndarray:
    return stacked.astype(np.float32) / 255.0


def _bicubic_upsample(frames: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(T,H,W,C) uint8 PIL-parity bicubic resize: the native library when it
    builds, Pillow otherwise (:func:`preprocess_path`)."""
    from crfp_torch import native

    if native.native_available():
        return native.resize_bicubic_u8(frames, oh, ow)
    return np.stack([
        np.array(PIL.Image.fromarray(im).resize((ow, oh), PIL.Image.BICUBIC))
        for im in frames
    ])


def preprocess_path() -> str:
    """The path the readers' bicubic resizes take: 'native' or 'pillow'."""
    from crfp_torch import native

    return "native" if native.native_available() else "pillow"


# bicubic upsample taps stay within +-3 source pixels for integer upscale;
# a 4-pixel margin around the crop makes crop-then-resize byte-identical
# to the reference's resize-then-crop (64x less resize work per sample)
_SR_MARGIN = 4


def _bicubic_x8_cropped(
    lr_win: np.ndarray, rnd_h: int, rnd_w: int, lr_size: int, scale: int
) -> np.ndarray:
    t, h, w, c = lr_win.shape
    m = _SR_MARGIN
    y0, y1 = max(rnd_h - m, 0), min(rnd_h + lr_size + m, h)
    x0, x1 = max(rnd_w - m, 0), min(rnd_w + lr_size + m, w)
    region = np.ascontiguousarray(lr_win[:, y0:y1, x0:x1])
    up = _bicubic_upsample(region, (y1 - y0) * scale, (x1 - x0) * scale)
    oy, ox = (rnd_h - y0) * scale, (rnd_w - x0) * scale
    g = lr_size * scale
    return up[:, oy : oy + g, ox : ox + g]


class _RedsBase:
    def __init__(self, args):
        self.args = args
        self.scale = args.scale
        self.gt_size = args.GT_size
        self.fv_size = args.FV_size
        self.n_frames = args.N_frames
        cache_dir = getattr(args, "frame_cache", None)
        if cache_dir:
            from crfp_torch.data.cache import FrameCache

            self._cache = FrameCache(cache_dir)
        else:
            self._cache = None

    def _load_frames(self, files, crop=None) -> np.ndarray:
        """(T, H, W, C) uint8 window, via the raw-frame cache when enabled.
        crop: optional (y0, y1, x0, x1) pushed into the memmap read."""
        if self._cache is not None:
            return self._cache.load_window(files, crop)
        frames = np.stack([_load(f) for f in files])
        if crop is not None:
            y0, y1, x0, x1 = crop
            frames = np.ascontiguousarray(frames[:, y0:y1, x0:x1])
        return frames

    def _frame_shape(self, path):
        if self._cache is not None:
            return self._cache.frame_shape(path)
        return np.array(PIL.Image.open(path)).shape

    def _load_window(self, gt_files, lr_files):
        gt = self._load_frames(gt_files)
        h, w = gt.shape[1:3]
        lr = self._load_frames(lr_files)
        lr_sr = _bicubic_upsample(lr, h, w)
        return list(gt), list(lr), list(lr_sr)


class TrainSet(_RedsBase):
    """minimal=True drops LR_sr (only consumed by y_only training,
    trainer.py:239-243) and the pre-multiplied fovea image Ref (the model
    blends ``fvs*mk`` on device anyway, so HR*mask can be formed on-chip —
    see main.py). Cuts per-sample host bytes ~2.5x."""

    def __init__(self, args, rng: np.random.Generator | None = None,
                 minimal: bool = False):
        super().__init__(args)
        self.minimal = minimal and not getattr(args, "y_only", False)
        self.rng = rng or np.random.default_rng()
        root = args.dataset_dir
        lroot = _lr_root(root, self.scale)

        def clips(base, sub, heldout):
            p = os.path.join(base, sub)
            return sorted(
                os.path.join(p, n) for n in os.listdir(p) if n not in heldout
            )

        gt_dirs = clips(root, "train/train/train_sharp", _TRAIN_HELDOUT) + clips(
            root, "val/val/val_sharp", _VAL_HELDOUT
        )
        lr_dirs = clips(lroot, "train/train/train_sharp", _TRAIN_HELDOUT) + clips(
            lroot, "val/val/val_sharp", _VAL_HELDOUT
        )
        self.gt_windows = _windows(gt_dirs, self.n_frames)
        self.lr_windows = _windows(lr_dirs, self.n_frames)

    def __len__(self):
        return len(self.gt_windows)

    def __getitem__(self, index):
        # LR frames are small (h/8 x w/8) — load the window whole; the GT
        # window is cropped inside the read so full 720p+ frames are never
        # copied out of the cache
        lr_win = self._load_frames(self.lr_windows[index])
        lr_size = self.gt_size // self.scale

        h, w = lr_win.shape[1:3]
        rnd_h = int(self.rng.integers(0, max(0, h - lr_size) + 1))
        rnd_w = int(self.rng.integers(0, max(0, w - lr_size) + 1))
        lr = np.ascontiguousarray(lr_win[:, rnd_h : rnd_h + lr_size, rnd_w : rnd_w + lr_size])
        rh, rw = rnd_h * self.scale, rnd_w * self.scale
        gt = self._load_frames(
            self.gt_windows[index], (rh, rh + self.gt_size, rw, rw + self.gt_size)
        )
        if self.minimal:
            gtf = _to_float(gt)
            _, ref_sp, _ = fovea_generator(
                gt, method="Nanascan", fv_hw=(self.fv_size, self.fv_size), rng=self.rng
            )
            sample = {
                "LR": _to_float(np.stack(lr)),
                "HR": gtf,
                "Ref_sp": ref_sp.astype(np.float32),
            }
            if self.rng.random() < 0.5:
                sample = {k: v[:, :, ::-1].copy() for k, v in sample.items()}
            if self.rng.random() < 0.5:
                sample = {k: v[:, ::-1].copy() for k, v in sample.items()}
            return sample
        # crop-then-resize with a tap margin == the reference's
        # full-frame-resize-then-crop, byte for byte
        lr_sr = _bicubic_x8_cropped(lr_win, rnd_h, rnd_w, lr_size, self.scale)
        ref, ref_sp, _ = fovea_generator(
            gt, method="Nanascan", fv_hw=(self.fv_size, self.fv_size), rng=self.rng
        )
        sample = {
            "LR": _to_float(np.stack(lr)),
            "LR_sr": _to_float(np.stack(lr_sr)),
            "HR": _to_float(gt),
            "Ref": _to_float(ref),
            "Ref_sp": ref_sp.astype(np.float32),
        }
        if self.rng.random() < 0.5:  # hflip
            sample = {k: v[:, :, ::-1].copy() for k, v in sample.items()}
        if self.rng.random() < 0.5:  # vflip
            sample = {k: v[:, ::-1].copy() for k, v in sample.items()}
        return sample


class _FixedSet(_RedsBase):
    sub: str
    clips_names: tuple[str, ...]

    def __init__(self, args):
        super().__init__(args)
        root = args.dataset_dir
        lroot = _lr_root(root, self.scale)
        gt_dirs = sorted(os.path.join(root, self.sub, n) for n in self.clips_names)
        lr_dirs = sorted(os.path.join(lroot, self.sub, n) for n in self.clips_names)
        self.gt_windows = _windows(gt_dirs, self.n_frames)
        self.lr_windows = _windows(lr_dirs, self.n_frames)

    def __len__(self):
        return len(self.gt_windows)

    def __getitem__(self, index):
        gt, lr, lr_sr = self._load_window(self.gt_windows[index], self.lr_windows[index])
        gt = np.stack(gt)
        ref, ref_sp, fv_sp = fovea_generator(
            gt, method="Evenscan", fv_hw=(self.fv_size, self.fv_size)
        )
        return {
            "LR": _to_float(np.stack(lr)),
            "LR_sr": _to_float(np.stack(lr_sr)),
            "HR": _to_float(gt),
            "Ref": _to_float(ref),
            "Ref_sp": ref_sp.astype(np.float32),
            "FV_sp": fv_sp,
        }


class EvalSet(_FixedSet):
    sub = "val/val/val_sharp"
    clips_names = _VAL_HELDOUT


class TestSet(_FixedSet):
    sub = "train/train/train_sharp"
    clips_names = _TRAIN_HELDOUT
