"""Foveated patch PSNR/SSIM heat-maps, kernel 10, stride 5
(crfp_tpu/eval/foveated.py).

Unfold SR and GT into k x k patches, score each patch independently (PSNR
from the patch's MSE; SSIM on the patch as its own zero-padded image),
reshape to an (Hr, Wr) heat-map, then normalise psnr/100 and
(ssim-0.7)/0.3. ``F.unfold`` yields the patch order the JAX code
reconstructs. The per-patch SSIM is a depthwise convolution over tens of
thousands of 10x10 images, as in the JAX package, which does not send it
through its SSIM kernel either.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from crfp_torch.ops.cuda.ssim import ssim_map_ref


def _extract_patches(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """(N, H, W, C) -> (N*Hr*Wr, k, k, C), torch-unfold patch order."""
    n, _, _, c = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), kernel_size=k, stride=s)  # (N, C*k*k, L)
    patches = cols.permute(0, 2, 1).reshape(n * cols.shape[-1], c, k, k)
    return patches.permute(0, 2, 3, 1)


def batch_psnr(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """Per-sample PSNR. (B, H, W, C) -> (B,)."""
    b = sr.shape[0]
    mse = ((sr - hr) ** 2).reshape(b, -1).mean(dim=1)
    floor = -20.0 * math.log10(math.sqrt((1.0 / 255.0) ** 2 / math.prod(sr.shape[1:])))
    return torch.where(mse == 0, torch.full_like(mse, floor),
                       -20.0 * torch.log10(torch.sqrt(mse)))


def batch_ssim(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """Per-sample mean of the SSIM map. (B, H, W, C) -> (B,)."""
    m = ssim_map_ref(sr.permute(0, 3, 1, 2), hr.permute(0, 3, 1, 2))
    return m.reshape(m.shape[0], -1).mean(dim=1)


@torch.no_grad()
def foveated_metric(sr: torch.Tensor, hr: torch.Tensor, kernel_size: int = 10,
                    stride: int = 5):
    """sr/hr: (H, W, 3). Returns (psnr_map, ssim_map, (pmin, pmax),
    (smin, smax))."""
    h, w, _ = sr.shape
    hr_r = (h - kernel_size) // stride + 1
    wr_r = (w - kernel_size) // stride + 1
    sp = _extract_patches(sr[None].float(), kernel_size, stride)
    hp = _extract_patches(hr[None].float(), kernel_size, stride)
    psnr = batch_psnr(sp, hp).reshape(hr_r, wr_r)
    ssim = batch_ssim(sp, hp).reshape(hr_r, wr_r)
    pminmax = (psnr.min(), psnr.max())
    sminmax = (ssim.min(), ssim.max())
    return psnr / 100.0, (ssim.clamp(0, 1) - 0.7) / 0.3, pminmax, sminmax
