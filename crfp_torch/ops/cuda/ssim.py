"""Kernel F dispatcher: the SSIM map.

Replaces ``crfp_tpu/ops/pallas/ssim.py::_ssim_kernel`` (:55, ``pallas_call``
in ``ssim_map_pallas`` :142) with ``crfp_torch/csrc/ssim.cu``: the five
moments under the 11x11 Gaussian window (sigma 1.5, zero 'same' padding)
as a vertical then a horizontal 11-tap pass over shared-memory tiles, and
the SSIM formula (C1 1e-4, C2 9e-4) in registers. The masked mean stays a
PyTorch reduction (``crfp_torch/ops/metrics.py``), as the TPU computes it
outside its kernel too (``ssim.py:165-169``). Forward only: a metric.

Bound on the H100 (bytes and f32 operations, see the source note): the
training step's RGB call on (14, 3, 192, 192) planes moves 18.6 MB, ~5.6 us
at 3.35 TB/s.

Layout: x, y (N, C, H, W) float32; the map has the same shape.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from crfp_torch.ops.cuda import _build

# launches of the CUDA kernel (not of the plain version)
launches = 0

WINDOW = 11
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


@functools.lru_cache(maxsize=1)
def gaussian_1d(sigma: float = 1.5) -> tuple[float, ...]:
    """The 1-D taps, normalised in float64 and rounded to float32 (the
    reference's order, crfp_tpu/ops/metrics.py:25-34); the 2-D window is
    their outer product."""
    g = np.array([math.exp(-((x - WINDOW // 2) ** 2) / (2.0 * sigma ** 2))
                  for x in range(WINDOW)], dtype=np.float64)
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def ssim_map_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version: the five moments by depthwise ``F.conv2d`` with zero
    'same' padding, the 11-tap column then the 11-tap row of the separable
    window (the order of kernel F and of the TPU kernel), then the SSIM
    formula; float32."""
    c = x.shape[1]
    g = torch.tensor(gaussian_1d(), dtype=torch.float32, device=x.device)
    wv = g.view(1, 1, WINDOW, 1).repeat(c, 1, 1, 1)
    wh = g.view(1, 1, 1, WINDOW).repeat(c, 1, 1, 1)
    x, y = x.float(), y.float()

    def conv(a):
        a = F.conv2d(a, wv, padding=(WINDOW // 2, 0), groups=c)
        return F.conv2d(a, wh, padding=(0, WINDOW // 2), groups=c)

    mu1, mu2 = conv(x), conv(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(x * x) - mu1_sq
    sigma2_sq = conv(y * y) - mu2_sq
    sigma12 = conv(x * y) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"ssim: x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4 or y.shape != x.shape:
        raise ValueError(f"ssim: x {tuple(x.shape)} and y {tuple(y.shape)} must "
                         "share one (N, C, H, W) shape")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"ssim: x {x.dtype} and y {y.dtype} must be float32")
    if y.device != x.device:
        raise ValueError(f"ssim: y on {y.device}, x on {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("ssim: x and y must be contiguous")
    if x.requires_grad or y.requires_grad:
        raise ValueError("ssim: kernel F has no backward; pass detached tensors")


def ssim_map(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM map of ``x`` against ``y`` (N, C, H, W), float32.

    CPU tensors take the plain version; CUDA tensors launch kernel F
    (float32, no gradient) or raise."""
    if x.device.type == "cpu":
        return ssim_map_ref(x, y)
    _check(x, y)
    n, c, h, w = x.shape
    out = torch.empty_like(x)
    taps = (ctypes.c_float * WINDOW)(*gaussian_1d())
    _build.launch("ssim", "crfp_ssim", _ARGTYPES, x.device,
                  x.data_ptr(), y.data_ptr(), out.data_ptr(), n * c, h, w,
                  ctypes.addressof(taps))
    global launches
    launches += 1
    return out
