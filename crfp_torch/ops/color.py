"""Color conversions with the reference's coefficients (crfp_tpu/ops/color.py).

- ``rgb2y``: the in-model luma of ``y_only`` mode, Y = .299R + .587G + .114B.
- ``rgb2yuv`` / ``yuv2rgb``: the trainer's pair; ``y_beside_uv`` uses them
  to put a ``y_only`` model's Y beside bicubic-upsampled UV.
- ``bgr2ycbcr_y``: the BT.601 "Y-channel metric" transform. The reference
  feeds RGB tensors into a function written for BGR, so the effective luma
  is ``24.966*R + 128.553*G + 65.481*B + 16``; the JAX package keeps that
  order (crfp_tpu/ops/color.py:45-49) and so does the port, since the
  metric numbers depend on it.

All take NHWC tensors; ``rgb2y`` and ``bgr2ycbcr_y`` return (N, H, W, 1).
"""

from __future__ import annotations

import torch


def rgb2y(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b)[..., None]


def rgb2yuv(rgb: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) RGB -> YUV with the trainer's coefficients."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.147 * r - 0.289 * g + 0.436 * b
    v = 0.615 * r - 0.515 * g - 0.100 * b
    return torch.stack([y, u, v], dim=-1)


def yuv2rgb(yuv: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) YUV -> RGB, the trainer's inverse of :func:`rgb2yuv`."""
    y, u, v = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    r = y + 1.14 * v
    g = y - 0.39 * u - 0.58 * v
    b = y + 2.03 * u
    return torch.stack([r, g, b], dim=-1)


def y_beside_uv(y: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """(..., 1) Y and (..., 3) RGB -> the RGB of ``y`` beside ``rgb``'s UV:
    the frame a ``y_only`` model is scored on, with ``rgb`` the bicubic
    upsample of its LR input (crfp_tpu/eval/evaluator.py:78-83)."""
    yuv = rgb2yuv(rgb.to(y.dtype))
    return yuv2rgb(torch.cat([y, yuv[..., 1:]], dim=-1))


def bgr2ycbcr_y(img: torch.Tensor) -> torch.Tensor:
    coeffs = torch.tensor([24.966, 128.553, 65.481], dtype=img.dtype, device=img.device)
    return (torch.tensordot(img, coeffs, dims=([-1], [0])) + 16.0)[..., None]
