"""Vimeo-90K septuplet readers (host side, numpy NHWC; crfp_tpu/data/vimeo.py).

The reference's Vimeo-90K readers: TrainSet/EvalSet from
sep_trainlist.txt / sep_testlist.txt with on-the-fly PIL-bicubic LR and
7-point Nanascan fovea; TestSet from slow_testset.txt with Hscan step=0.2.
Also ports the DUF-style 13x13 Gaussian downsampling helper
as pure numpy/scipy.
"""

from __future__ import annotations

import os

import numpy as np
import PIL.Image

from crfp_torch.data.fovea import fovea_generator


def gaussian_downsample(x: np.ndarray, scale: int = 4) -> np.ndarray:
    """DUF Gaussian downsampling. x: (T, H, W, C) float; returns (T,H/s,W/s,C)."""
    assert scale in (2, 3, 4), scale
    from scipy import ndimage

    sigma = 0.4 * scale
    kern = np.zeros((13, 13))
    kern[6, 6] = 1
    kern = ndimage.gaussian_filter(kern, sigma)

    pad = 6 + scale * 2
    r_h = r_w = 0
    if scale == 3:
        r_h = 3 - (x.shape[1] % 3)
        r_w = 3 - (x.shape[2] % 3)
    xp = np.pad(x, ((0, 0), (pad, pad + r_h), (pad, pad + r_w), (0, 0)), mode="reflect")

    t, hp, wp, c = xp.shape
    oh = (hp - 13) // scale + 1
    ow = (wp - 13) // scale + 1
    out = np.zeros((t, oh, ow, c), x.dtype)
    for dy in range(13):
        for dx in range(13):
            out += kern[dy, dx] * xp[:, dy : dy + oh * scale : scale, dx : dx + ow * scale : scale, :]
    return out[:, 2:-2, 2:-2, :]


def _load_seq(d: str) -> list[np.ndarray]:
    return [np.array(PIL.Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))]


def _to_float(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32) / 255.0


class _VimeoBase:
    list_file: str
    lr_suffix: str = "90k_BD"

    def __init__(self, args):
        self.args = args
        self.scale = args.scale
        self.gt_size = args.GT_size
        self.fv_size = args.FV_size
        self.gt_dirs = []
        with open(os.path.join(args.dataset_dir, self.list_file)) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.gt_dirs.append(os.path.join(args.dataset_dir, "sequences", line))

    def __len__(self):
        return len(self.gt_dirs)

    def _load_lr(self, gt_imgs):
        h, w, _ = gt_imgs[0].shape
        return [
            np.array(
                PIL.Image.fromarray(im).resize((w // self.scale, h // self.scale), PIL.Image.BICUBIC)
            )
            for im in gt_imgs
        ]


class TrainSet(_VimeoBase):
    list_file = "sep_trainlist.txt"

    def __init__(self, args, rng: np.random.Generator | None = None,
                 minimal: bool = False):
        super().__init__(args)
        self.minimal = minimal and not getattr(args, "y_only", False)
        self.rng = rng or np.random.default_rng()

    def __getitem__(self, index):
        gt = _load_seq(self.gt_dirs[index])
        lr = self._load_lr(gt)
        lr_size = self.gt_size // self.scale

        h, w, _ = lr[0].shape
        rnd_h = int(self.rng.integers(0, max(0, h - lr_size) + 1))
        rnd_w = int(self.rng.integers(0, max(0, w - lr_size) + 1))
        lr = [v[rnd_h : rnd_h + lr_size, rnd_w : rnd_w + lr_size] for v in lr]
        rh, rw = rnd_h * self.scale, rnd_w * self.scale
        gt = [v[rh : rh + self.gt_size, rw : rw + self.gt_size] for v in gt]

        gt = np.stack(gt)
        ref, ref_sp, _ = fovea_generator(
            gt, method="Nanascan", fv_hw=(self.fv_size, self.fv_size),
            rng=self.rng, nanascan_grid="vimeo7",
        )
        sample = {
            "LR": _to_float(np.stack(lr)),
            "HR": _to_float(gt),
            "Ref_sp": ref_sp.astype(np.float32),
        }
        if not self.minimal:
            sample["Ref"] = _to_float(ref)
        if self.rng.random() < 0.5:
            sample = {k: v[:, :, ::-1].copy() for k, v in sample.items()}
        if self.rng.random() < 0.5:
            sample = {k: v[:, ::-1].copy() for k, v in sample.items()}
        return sample


class EvalSet(_VimeoBase):
    list_file = "sep_testlist.txt"

    def __getitem__(self, index):
        gt = _load_seq(self.gt_dirs[index])
        lr = self._load_lr(gt)
        gt = np.stack(gt)
        ref, ref_sp, _ = fovea_generator(
            gt, method="Nanascan", fv_hw=(self.fv_size, self.fv_size),
            rng=np.random.default_rng(index), nanascan_grid="vimeo7",
        )
        return {
            "LR": _to_float(np.stack(lr)),
            "HR": _to_float(gt),
            "Ref": _to_float(ref),
            "Ref_sp": ref_sp.astype(np.float32),
        }


class TestSet(_VimeoBase):
    list_file = "slow_testset.txt"
    lr_suffix = "90k_LR"

    def __getitem__(self, index):
        gt = _load_seq(self.gt_dirs[index])
        lr = self._load_lr(gt)
        gt = np.stack(gt)
        ref, ref_sp, fv_sp = fovea_generator(
            gt, method="Hscan", step=0.2, fv_hw=(self.fv_size, self.fv_size)
        )
        return {
            "LR": _to_float(np.stack(lr)),
            "HR": _to_float(gt),
            "Ref": _to_float(ref),
            "Ref_sp": ref_sp.astype(np.float32),
            "FV_sp": fv_sp,
        }
