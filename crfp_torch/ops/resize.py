"""Bilinear resize and 2x average pool, NCHW (crfp_tpu/ops/resize.py:29-142).

``F.interpolate(mode='bilinear')`` semantics, no antialiasing on
downscale; the JAX package builds the same interpolation as two dense
matrices so that it lands on the TPU's matrix unit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear-resize NCHW ``x`` to spatial size ``out_hw``."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def upsample(x: torch.Tensor, scale: int | float,
             align_corners: bool = False) -> torch.Tensor:
    """``nn.Upsample(scale_factor=scale)``: output size ``floor(in * scale)``."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (math.floor(h * scale), math.floor(w * scale)),
                           align_corners=align_corners)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 average pool (odd trailing rows/columns dropped)."""
    return F.avg_pool2d(x, 2, 2)
