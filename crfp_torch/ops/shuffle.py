"""Space-to-depth / depth-to-space, NCHW (crfp_tpu/ops/shuffle.py).

Channel order is torch's: channel ``c*f*f + dy*f + dx`` holds input
channel ``c`` at spatial phase ``(dy, dx)`` — the order the JAX package
keeps in NHWC (crfp_tpu/ops/shuffle.py:16,27), so weights line up.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N, C*f*f, H, W) -> (N, C, H*f, W*f)."""
    return F.pixel_shuffle(x, factor)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N, C, H*f, W*f) -> (N, C*f*f, H, W)."""
    return F.pixel_unshuffle(x, factor)
