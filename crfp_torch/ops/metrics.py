"""Masked PSNR and SSIM with the reference's semantics (crfp_tpu/ops/metrics.py).

- masked PSNR: ``mse = ((a-b)^2 * mask).sum() / (mask.sum() * C)``, then
  ``-20*log10(sqrt(mse))``; a zero error gives the floor of one 8-bit step
  spread over every element (:37-45).
- masked SSIM: the SSIM map (11x11 Gaussian window, sigma 1.5, zero 'same'
  padding, C1 0.01^2, C2 0.03^2 on [0, 1] images), masked mean over
  ``mask.sum() * C`` (:64-99). The map is kernel F on CUDA tensors
  (``crfp_torch/ops/cuda/ssim.py``, forward only), which reads both
  images in place, each in its own layout (the training step's output is
  an NHWC view of NCHW memory, its ground truth NHWC), and its plain
  version on CPU tensors.
- ``psnr_and_ssim``: the range heuristic of the reference's
  ``calc_psnr_and_ssim_cuda`` first (:102-111): a ground truth spanning
  more than 2 is taken as [0, 255], more than 1 as [-1, 1].

Inputs are NHWC; the mask is (N, H, W, 1), broadcast over channels.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from crfp_torch.ops.cuda.ssim import gaussian_1d, ssim_map


def _gaussian_window() -> np.ndarray:
    """The 11x11 window: the outer product of the f32-normalised 1-D taps."""
    g = np.asarray(gaussian_1d(), np.float32)
    return np.outer(g, g).astype(np.float32)


def _global(num: torch.Tensor, den: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """(num, den) summed over the ranks of ``group`` (None: as they are)."""
    if group is None:
        return num, den
    sums = torch.stack([num, den])
    dist.all_reduce(sums, group=group)
    return sums[0], sums[1]


def masked_psnr(sr: torch.Tensor, hr: torch.Tensor, mask: torch.Tensor,
                group=None) -> torch.Tensor:
    """PSNR over the masked region of [0, 1]-ranged NHWC images. ``group``:
    the images are this rank's shard of a batch split over the group's
    ranks in equal parts; the squared-error and mask sums are reduced over
    the ranks before the division, and the zero-error floor counts the
    global elements, so every rank gets the PSNR of the global batch."""
    c = sr.shape[-1]
    mask = mask.to(sr.dtype)
    err, den = _global((((sr - hr) ** 2) * mask).sum(), mask.sum(), group)
    mse = err / (den * c)
    n = math.prod(sr.shape)
    if group is not None:
        n *= dist.get_world_size(group)
    zero_floor = -20.0 * math.log10(math.sqrt((1.0 / 255.0) ** 2 / n))
    return torch.where(mse == 0, torch.full_like(mse, zero_floor),
                       -20.0 * torch.log10(torch.sqrt(mse)))


def masked_ssim(sr: torch.Tensor, hr: torch.Tensor, mask: torch.Tensor,
                group=None) -> torch.Tensor:
    """Masked mean of the SSIM map of [0, 1]-ranged NHWC images (``group``:
    as in :func:`masked_psnr`, the masked map sum and the mask sum reduced
    over the ranks). On the card the inputs must not require grad (kernel F
    has no backward)."""
    c = sr.shape[-1]
    smap = ssim_map(sr.float().permute(0, 3, 1, 2), hr.float().permute(0, 3, 1, 2))
    mask = mask.to(smap.dtype).permute(0, 3, 1, 2)
    num, den = _global((smap * mask).sum(), mask.sum(), group)
    return num / (den * c)


def psnr_and_ssim(sr: torch.Tensor, hr: torch.Tensor, mask: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Range-normalise like the reference, then masked PSNR and SSIM."""
    rng = float(hr.max() - hr.min())
    if rng > 2:
        sr, hr = sr / 255.0, hr / 255.0
    elif rng > 1:
        sr, hr = (sr + 1.0) / 2.0, (hr + 1.0) / 2.0
    return masked_psnr(sr, hr, mask), masked_ssim(sr, hr, mask)
