"""Color conversions with the reference's coefficients (crfp_tpu/ops/color.py).

- ``rgb2y``: the in-model luma of ``y_only`` mode, Y = .299R + .587G + .114B.
- ``bgr2ycbcr_y``: the BT.601 "Y-channel metric" transform. The reference
  feeds RGB tensors into a function written for BGR, so the effective luma
  is ``24.966*R + 128.553*G + 65.481*B + 16``; the JAX package keeps that
  order (crfp_tpu/ops/color.py:45-49) and so does the port, since the
  metric numbers depend on it.

Both take NHWC tensors and return (N, H, W, 1).
"""

from __future__ import annotations

import torch


def rgb2y(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b)[..., None]


def bgr2ycbcr_y(img: torch.Tensor) -> torch.Tensor:
    coeffs = torch.tensor([24.966, 128.553, 65.481], dtype=img.dtype, device=img.device)
    return (torch.tensordot(img, coeffs, dims=([-1], [0])) + 16.0)[..., None]
