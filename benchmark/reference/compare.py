"""The numbers the comparison reports, each judged against its limit.

- `widest_gap`: over every row, how far the reference score (with the
  draw's own Gumbel noise) of the slot the program chose lies below the
  reference's best slot. An exact draw reads 0 up to rounding; a slot out
  of range reads infinity.
- `rel_gap`: |program - reference| / |reference|.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Blocks = Callable[[int, int], torch.Tensor]


def widest_gap(scores: Blocks, noise: Blocks, z: torch.Tensor, n: int, rows: int = 65536) -> float:
    """scores(lo, hi) and noise(lo, hi) give rows lo..hi-1 as [rows, K] (or
    [rows, C, K] with z [rows, C]); z holds the program's slots."""
    worst = 0.0
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        s = scores(lo, hi).to(torch.float64) + noise(lo, hi)
        zz = z[lo:hi].to(torch.int64)
        if bool(((zz < 0) | (zz >= s.shape[-1])).any()):
            return math.inf
        gap = s.amax(-1) - s.gather(-1, zz[..., None])[..., 0]
        worst = max(worst, float(gap.max()))
    return worst


def argmax_draw(scores: Blocks, noise: Blocks, n: int, rows: int = 65536) -> torch.Tensor:
    """The control's draw: argmax of its own scores plus the same noise."""
    out = []
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        out.append(torch.argmax(scores(lo, hi).to(torch.float64) + noise(lo, hi), dim=-1))
    return torch.cat(out)


def rel_gap(value: float, reference: float) -> float:
    if not (math.isfinite(value) and math.isfinite(reference)):
        return math.inf
    return abs(value - reference) / max(abs(reference), 1e-300)
