"""Order-fixed segment sums: the port's counterpart of `jax.ops.segment_sum`.

`Tensor.index_add_` and `scatter_add_` add floats with atomics on a CUDA
tensor, so the order of the adds into one output row, and with it the
rounding, changes from call to call. Here the rows are grouped by segment
with a stable sort (row order within a segment), each segment's rows are
cut into pieces of at most PIECE rows at fixed offsets from its start, and
two `torch.segment_reduce` calls sum them: each piece's rows in order, then
each segment's pieces in order, one thread an output element. So every
output element is summed in an order fixed by the inputs alone, on the
CPU and on the card alike (the same code runs on both), and a segment of a
million rows still spreads over many threads. Nothing here reads a device
value on the host: every shape follows from the rows' count and `n`.

    segment_sum(values, ids, n)       one call
    segments(ids, n).sum(values)      a layout shared by several leaves
    sorted_segments(ids, n).sum(v)    rows already grouped by segment

A segment's pieces are summed by one thread, so the second call takes as
long as the largest segment has pieces: where few segments share many rows,
its time follows how the rows fall into them. `tree=True` sums the pieces
PIECE at a time again, level by level, until no thread can sum more than
PIECE of anything whatever the ids; the levels follow from the rows' count
alone, so the time no longer follows the data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

PIECE = 64  # rows one thread sums at the first level


@dataclasses.dataclass(frozen=True)
class Segments:
    """Where each segment's rows lie once the rows are grouped by segment.

    order [M] (None where the rows come grouped) gathers the rows into
    segment order, dropped rows last; pieces [M // PIECE + n + 1] are the
    row offsets of the pieces (a segment's rows cut every PIECE rows from
    its start; the slots past the last piece are empty); first [n + 1] is
    each segment's first piece, first[n] one past the last piece. inner
    (a tree's levels, empty otherwise) holds the offsets of each further
    level's pieces, each cutting a segment's pieces of the level below every
    PIECE from its start; first then indexes the last level's pieces.
    """

    order: Optional[torch.Tensor]
    pieces: torch.Tensor
    first: torch.Tensor
    n: int
    inner: Tuple[torch.Tensor, ...] = ()

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """[n, *event] sum of values [M, *event] over each segment's rows."""
        event = values.shape[1:]
        if self.order is not None:
            values = values.index_select(0, self.order)
        flat = values.reshape(values.shape[0], event.numel())  # 2-D: one thread an element, every level
        part = torch.segment_reduce(flat, "sum", offsets=self.pieces, unsafe=True)
        for offsets in self.inner:
            part = torch.segment_reduce(part, "sum", offsets=offsets, unsafe=True)
        out = torch.segment_reduce(part, "sum", offsets=self.first, unsafe=True)
        return out.reshape(self.n, *event)


def sorted_segments(ids: torch.Tensor, n: int, order: Optional[torch.Tensor] = None,
                    tree: bool = False, bound: Optional[int] = None) -> Segments:
    """The layout of rows whose ids [M] are sorted, each in [0, n]; rows with
    id n are dropped (they come last). `order`, where given, is the gather
    that brought the rows into this order. With `tree`, further levels while
    a segment (at most `bound` rows, M if not given) could have more than
    PIECE pieces."""
    dev = ids.device
    start = torch.searchsorted(ids, torch.arange(n + 1, device=dev, dtype=ids.dtype))  # [n + 1] row offsets
    count = torch.diff(start).add_(PIECE - 1).div_(PIECE, rounding_mode="floor")
    first = torch.nn.functional.pad(torch.cumsum(count, 0), (1, 0))  # [n + 1] piece offsets
    u = torch.arange(ids.shape[0] // PIECE + n, device=dev)  # bounds the piece count
    seg = torch.searchsorted(first[1:], u, right=True).clamp_(max=max(n - 1, 0))
    # piece u starts PIECE * (u - first[seg]) rows into its segment; a slot past
    # the last piece lands at or past start[n], and the minimum makes it empty there
    lo = (start - first * PIECE)[seg].add_(u, alpha=PIECE)
    kept = start[n:]
    pieces = torch.cat([torch.minimum(lo, kept), kept])
    bound = ids.shape[0] if bound is None else bound
    if not tree or -(-bound // PIECE) <= PIECE:
        return Segments(order, pieces, first, n)
    # the next level's rows are these pieces, by segment; the empty slots last, dropped
    up = sorted_segments(torch.where(u < first[n], seg, n).to(ids.dtype), n, tree=True, bound=-(-bound // PIECE))
    return Segments(order, pieces, up.first, n, (up.pieces, *up.inner))


def segments(ids: torch.Tensor, n: int, tree: bool = False) -> Segments:
    """The layout of rows with ids [M]; rows with an id outside [0, n) are
    dropped. One stable sort of the ids. `tree`: as `sorted_segments`."""
    key = ids.clamp(-1, n).to(torch.int32 if n < 2**31 - 1 else torch.int64).remainder_(n + 1)  # -1 -> n
    key, order = torch.sort(key, stable=True)
    return sorted_segments(key, n, order, tree=tree)


def segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """[n, *event] sum of values [M, *event] over the rows of each id in
    [0, n), in an order fixed by the inputs; other ids are dropped."""
    return segments(ids, n).sum(values)
