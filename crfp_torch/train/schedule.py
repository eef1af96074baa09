"""Cosine annealing with restarts (mmcv style), per iteration
(crfp_tpu/train/schedule.py:18-43).

Within restart period ``idx``: ``lr = min_lr + 0.5 * weight * (base -
min_lr) * (cos(pi * alpha) + 1)`` with ``alpha = min((it - start) / period,
1)``. Defaults are the recipe of record: one 600k-iteration period, min_lr
1e-7. The schedule is a plain Python function of the step; the train step
writes it into the optimizer's ``lr`` before every update.
"""

from __future__ import annotations

import itertools
import math
from collections.abc import Callable, Sequence


def cosine_restart_schedule(
    base_lr: float,
    periods: Sequence[int] = (600_000,),
    restart_weights: Sequence[float] = (1.0,),
    min_lr: float = 1e-7,
) -> Callable[[int], float]:
    """Returns ``schedule(count) -> lr``."""
    if len(periods) != len(restart_weights):
        raise ValueError(f"{len(periods)} periods but {len(restart_weights)} weights")
    cumulative = list(itertools.accumulate(periods))
    starts = [0] + cumulative[:-1]

    def schedule(count: int) -> float:
        # the active restart period, clamped to the last one
        idx = min(sum(count >= c for c in cumulative), len(periods) - 1)
        alpha = min((count - starts[idx]) / periods[idx], 1.0)
        return min_lr + 0.5 * restart_weights[idx] * (base_lr - min_lr) * (
            math.cos(math.pi * alpha) + 1.0)

    return schedule
