"""Checkpoint evaluation over eval/test loaders (crfp_tpu/eval/evaluator.py).

Per-frame masked PSNR/SSIM in RGB and in the (mis-ordered-coefficient) Y
domain with a full-ones mask, skipping frame 0 of every 50th window (the
reference's clip-boundary reset rule), averaged over all frames. With
``y_only`` the model's Y goes beside the UV of the batch's bicubic-upsampled
LR frames (``LR_sr``) and back to RGB (crfp_tpu/eval/evaluator.py:78-83).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from crfp_torch.ops.color import bgr2ycbcr_y, y_beside_uv
from crfp_torch.ops.metrics import masked_psnr, masked_ssim


@dataclasses.dataclass
class EvalResult:
    psnr: float
    ssim: float
    psnr_y: float
    ssim_y: float
    n_frames: int

    def __str__(self):
        return (
            f"PSNR {self.psnr:.3f}  SSIM {self.ssim:.4f}  "
            f"PSNR_Y {self.psnr_y:.3f}  SSIM_Y {self.ssim_y:.4f}  ({self.n_frames} frames)"
        )


@torch.no_grad()
def _frame_metrics(sr: torch.Tensor, hr: torch.Tensor) -> np.ndarray:
    """Per-frame RGB and Y metrics with a ones mask. sr/hr: (T, H, W, 3) in
    [0, 1]. Returns (T, 4): psnr, ssim, psnr_y, ssim_y."""
    m = torch.ones_like(sr[:1, ..., :1])
    rows = []
    for s, h in zip(sr.float().split(1), hr.float().split(1)):
        # Y-domain values are ~[16, 235]; the reference's range heuristic
        # divides by 255
        sy, hy = bgr2ycbcr_y(s) / 255.0, bgr2ycbcr_y(h) / 255.0
        rows.append(torch.stack([masked_psnr(s, h, m), masked_ssim(s, h, m),
                                 masked_psnr(sy, hy, m), masked_ssim(sy, hy, m)]))
    return torch.stack(rows).cpu().numpy()


@torch.no_grad()
def evaluate_clips(model, loader, y_only: bool = False, log=None,
                   save_dir: str | None = None) -> EvalResult:
    """``model``: a ``crfp_torch.models.crfp.CRFP`` with its weights loaded,
    on its device. ``loader``: any iterable of ``{"LR", "Ref", "Ref_sp",
    "HR"}`` batches of (B, T, H, W, C) arrays, with ``"LR_sr"`` (B, T, H,
    W, 3) too for a ``y_only`` model. ``save_dir``: when set, SR frames are
    written there as PNGs."""
    p = next(model.parameters())
    model.eval()
    cols = []
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
    for i_batch, batch in enumerate(loader):
        lr, fv, mk, hr = (torch.as_tensor(np.asarray(batch[k])).to(p.device, p.dtype)
                          for k in ("LR", "Ref", "Ref_sp", "HR"))
        sr = model(lr, fv, mk).float()
        if y_only:
            lrsr = torch.as_tensor(np.asarray(batch["LR_sr"])).to(p.device)
            sr = y_beside_uv(sr[..., :1], lrsr)
        b, t = sr.shape[:2]
        if save_dir is not None:
            import PIL.Image

            arr = (sr.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()
            for bi in range(b):
                for ti in range(t):
                    PIL.Image.fromarray(arr[bi, ti]).save(
                        os.path.join(save_dir, f"sr_{i_batch:05d}_{bi}_{ti:02d}.png"))
        vals = _frame_metrics(sr.reshape(b * t, *sr.shape[2:]),
                              hr.float().reshape(b * t, *hr.shape[2:]))
        cols.append(vals[1 if i_batch % 50 == 0 else 0:])
        if log is not None and i_batch % 50 == 0:
            done = np.concatenate(cols)
            log(f"eval[{i_batch}] PSNR {done[:, 0].mean():.3f} SSIM {done[:, 1].mean():.4f}")
    vals = np.concatenate(cols)
    return EvalResult(*(float(v) for v in vals.mean(0)), len(vals))
