"""Slice sampling of one coordinate, written from Neal, "Slice sampling" (2003).

One update of x0 under the density exp(logf): the level y = logf(x0) +
log u with u ~ U(0, 1), an interval of width w placed at random around x0
and stepped out (at most `max_stepout` steps a side, clipped to the
bounds) while its ends lie above y, then shrunk towards x0 until a
uniform proposal lies above y (after `max_shrink` proposals x0 stays).
`uniform()` gives the U(0, 1) draws, the level's first.

`level_gaps` judges updates that have been made: for each, how far the new
point's log density lies below the level its update drew, in float64.
An update that keeps to its slice reads at most 0 up to the rounding of
the target it used.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def update(logf: Callable[[float], float], x0: float, uniform: Callable[[], float], w: float,
           lower: float = -math.inf, upper: float = math.inf, max_stepout: int = 16,
           max_shrink: int = 64) -> tuple:
    """(x1, log u): the new point and the log of the level's uniform."""
    log_u = math.log(max(uniform(), 1e-300))
    y = logf(x0) + log_u
    lo = max(x0 - uniform() * w, lower)
    hi = min(lo + w, upper)
    for _ in range(max_stepout):
        if lo <= lower or not logf(lo) > y:
            break
        lo = max(lo - w, lower)
    for _ in range(max_stepout):
        if hi >= upper or not logf(hi) > y:
            break
        hi = min(hi + w, upper)
    for _ in range(max_shrink):
        x1 = lo + uniform() * (hi - lo)
        if logf(x1) >= y:
            return x1, log_u
        if x1 < x0:
            lo = x1
        else:
            hi = x1
    return x0, log_u


def level_gaps(log_u: torch.Tensor, logf_new: torch.Tensor, logf_old: torch.Tensor) -> torch.Tensor:
    """log u - (logf(x1) - logf(x0)) of each update, float64: above 0 where
    the new point lies below the level the update drew."""
    return log_u.to(torch.float64) - (logf_new.to(torch.float64) - logf_old.to(torch.float64))
