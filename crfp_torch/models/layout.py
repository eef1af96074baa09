"""The layout at the models' entry points: NHWC outside, NCHW inside.

``nchw`` makes a contiguous NCHW copy of an NHWC tensor; ``nhwc`` returns
an NHWC view of NCHW storage (no copy).
"""

from __future__ import annotations

import torch


def nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2).contiguous()


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def nchw_or_none(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else nchw(t)
