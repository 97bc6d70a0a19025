"""The port's order-fixed segment sum (`common_tpu_torch/utils/segment.py`).

`segment_sum(values, ids, n)` is held to a float64 `index_add_` of the same
seeded numpy rows at float32's rounding (and exactly in float64 where the
addends are integers), across empty segments, ragged ones, segments that
cross the PIECE boundaries, dropped ids (negative, n and past n), event
shapes and id dtypes; and to its own definition of the order bit for bit:
each segment's rows in row order, cut every PIECE rows from the segment's
start, each piece summed in order, then the pieces in order. So the sum of
one segment does not move when dropped rows or other segments' rows are
added, removed or shuffled, and a layout built once serves every leaf.
The tree layout (`tree=True`) is held the same way to its own order, and to
its bound: no thread of any level sums more than PIECE rows or pieces.
"""

import numpy as np
import pytest
import torch

from common_tpu_torch.utils import segment
from common_tpu_torch.utils.segment import PIECE

torch.set_num_threads(2)

RAGGED = [0, 1, PIECE - 1, PIECE, PIECE + 1, 3 * PIECE, 0, 5, 2 * PIECE + 7, 0]


def _rows(lengths, event, seed, dropped=0):
    """Rows of segment e repeated lengths[e] times, shuffled, plus `dropped`
    rows with ids outside [0, n)."""
    r = np.random.default_rng(seed)
    n = len(lengths)
    ids = np.concatenate([np.repeat(np.arange(n), lengths), r.choice([-3, -1, n, n + 4], dropped)])
    r.shuffle(ids)
    values = r.normal(size=(len(ids), *event)) * r.choice([1e-3, 1.0, 1e3], (len(ids), *event))
    return ids, values


def _reference(values, ids, n):
    """The definition of the order, in Python: each segment's rows in row
    order, PIECE at a time from its start, the pieces summed in order."""
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype)
    for e in range(n):
        rows = values[ids == e]
        total = torch.zeros(values.shape[1:], dtype=values.dtype)
        for lo in range(0, rows.shape[0], PIECE):
            piece = torch.zeros(values.shape[1:], dtype=values.dtype)
            for row in rows[lo:lo + PIECE]:
                piece = piece + row
            total = total + piece
        out[e] = total
    return out


@pytest.mark.parametrize("event", [(), (3,), (2, 2)])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_segment_sum_matches_float64_index_add(event, id_dtype):
    """Ragged, empty and long segments with dropped ids: float32 within its
    rounding of a float64 index_add_, float64 on integer addends exactly."""
    ids, values = _rows(RAGGED, event, seed=1, dropped=40)
    n = len(RAGGED)
    t_ids = torch.from_numpy(ids).to(id_dtype)
    keep = (ids >= 0) & (ids < n)
    want = torch.zeros((n, *event), dtype=torch.float64).index_add_(
        0, torch.from_numpy(ids[keep]), torch.from_numpy(values[keep]))
    got = segment.segment_sum(torch.from_numpy(values).float(), t_ids, n)
    assert got.dtype == torch.float32 and got.shape == (n, *event)
    scale = torch.from_numpy(np.abs(values)).max().item() * max(RAGGED)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0, atol=4e-7 * scale)
    counts = torch.from_numpy(np.round(values * 10))
    got64 = segment.segment_sum(counts, t_ids, n)
    want64 = torch.zeros((n, *event), dtype=torch.float64).index_add_(
        0, torch.from_numpy(ids[keep]), counts[torch.from_numpy(keep)])
    assert torch.equal(got64, want64)
    for e in np.nonzero(np.array(RAGGED) == 0)[0]:
        assert torch.equal(got[e], torch.zeros(event))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_sum_follows_its_order_bit_for_bit(seed):
    """float32 sums equal the Python definition of the order exactly."""
    ids, values = _rows(RAGGED, (2,), seed=seed, dropped=9)
    v = torch.from_numpy(values).float()
    t_ids = torch.from_numpy(ids)
    assert torch.equal(segment.segment_sum(v, t_ids, len(RAGGED)), _reference(v, t_ids, len(RAGGED)))


def test_a_segment_ignores_other_rows():
    """Adding dropped rows (mask-0 padding), and moving and shuffling the
    rows of other segments, leave a segment's float32 sum the same bit for
    bit."""
    ids, values = _rows(RAGGED, (), seed=3)
    n = len(RAGGED)
    v, t_ids = torch.from_numpy(values).float(), torch.from_numpy(ids)
    base = segment.segment_sum(v, t_ids, n)
    padded = segment.segment_sum(torch.cat([v, torch.ones(17)]),
                                 torch.cat([t_ids, torch.full((17,), n)]), n)
    assert torch.equal(padded, base)
    # segment 4's rows in their order, every other row reversed around them
    four = torch.nonzero(t_ids == 4).flatten()
    others = torch.nonzero(t_ids != 4).flatten().flip(0)
    order = torch.cat([others[:50], four, others[50:]])
    moved = segment.segment_sum(v[order], t_ids[order], n)
    assert torch.equal(moved[4], base[4])
    # segment 4 alone, with no rows of other segments before it
    alone = segment.segment_sum(v[four], torch.zeros(len(four), dtype=torch.int64), 1)
    assert torch.equal(alone[0], base[4])


def test_sorted_layout_on_chunks_and_shared_leaves():
    """`sorted_segments` of a slice of sorted rows (a chunk whose edges cut
    segments) sums that slice's part of each segment; one layout serves
    several leaves of different events and dtypes."""
    ids, values = _rows(RAGGED, (), seed=4, dropped=5)
    n = len(RAGGED)
    key = np.where((ids >= 0) & (ids < n), ids, n)
    order = np.argsort(key, kind="stable")
    key, v = torch.from_numpy(key[order]), torch.from_numpy(values[order])
    for lo, hi in ((0, 70), (70, 200), (200, len(key))):
        seg = segment.sorted_segments(key[lo:hi], n)
        k = key[lo:hi]
        want = torch.zeros(n, dtype=torch.float64).index_add_(0, k[k < n], v[lo:hi][k < n])
        np.testing.assert_allclose(seg.sum(v[lo:hi]).numpy(), want.numpy(), rtol=1e-12, atol=1e-9)
    layout = segment.segments(torch.from_numpy(ids), n)
    leaves = {"n": torch.ones(len(ids)), "sum_x": torch.from_numpy(values)[:, None].repeat(1, 3)}
    got = {k: layout.sum(t) for k, t in leaves.items()}
    assert torch.equal(got["n"], torch.tensor(RAGGED, dtype=torch.float32))
    assert got["sum_x"].shape == (n, 3) and got["sum_x"].dtype == torch.float64
    assert torch.equal(got["sum_x"], segment.segment_sum(leaves["sum_x"], torch.from_numpy(ids), n))


def test_no_rows_and_no_segments():
    assert torch.equal(segment.segment_sum(torch.zeros((0, 2)), torch.zeros(0, dtype=torch.int64), 3),
                       torch.zeros((3, 2)))
    assert segment.segment_sum(torch.ones(4), torch.zeros(4, dtype=torch.int64), 0).shape == (0,)


def _tree_reference(values, ids, n):
    """The tree's order, in Python: each segment's rows cut PIECE at a time
    from its start and each piece summed in order, then the same again on
    the pieces, level by level, while a segment of all the rows would have
    more than PIECE pieces; the last level's pieces summed in order."""
    bound = len(ids)
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype)
    for e in range(n):
        rows, b = list(values[ids == e]), bound
        while True:
            pieces = []
            for lo in range(0, len(rows), PIECE):
                piece = torch.zeros(values.shape[1:], dtype=values.dtype)
                for row in rows[lo:lo + PIECE]:
                    piece = piece + row
                pieces.append(piece)
            rows = pieces
            if -(-b // PIECE) <= PIECE:
                break
            b = -(-b // PIECE)
        total = torch.zeros(values.shape[1:], dtype=values.dtype)
        for piece in rows:
            total = total + piece
        out[e] = total
    return out


# a few long segments, as the IRM restat's blocks once the clusters settle
LONG = [3 * PIECE * PIECE + 5, 0, 17, PIECE * PIECE, 1, 2 * PIECE + 1]


@pytest.mark.parametrize("lengths, levels", [(RAGGED, 0), (LONG, 1), ([PIECE ** 3 + 1, 3], 2)])
def test_tree_levels_bound_every_thread(lengths, levels):
    """`tree=True` adds a level while a segment of all the rows could have
    more than PIECE pieces, the count following from the rows alone; at
    every level no thread sums more than PIECE rows or pieces."""
    ids, _ = _rows(lengths, (), seed=5, dropped=3)
    layout = segment.segments(torch.from_numpy(ids), len(lengths), tree=True)
    assert len(layout.inner) == levels
    for offsets in (layout.pieces, *layout.inner, layout.first):
        assert int(torch.diff(offsets).max()) <= PIECE
    assert segment.segments(torch.from_numpy(ids), len(lengths)).inner == ()


@pytest.mark.parametrize("event", [(), (3,)])
def test_tree_segment_sum_matches_float64_and_its_order(event):
    """The tree's float32 sums lie within their rounding of a float64
    index_add_, equal its Python order bit for bit, and on integer addends
    equal the two-level sum exactly."""
    ids, values = _rows(LONG, event, seed=6, dropped=30)
    n = len(LONG)
    t_ids, v = torch.from_numpy(ids), torch.from_numpy(values).float()
    keep = (ids >= 0) & (ids < n)
    layout = segment.segments(t_ids, n, tree=True)
    got = layout.sum(v)
    want = torch.zeros((n, *event), dtype=torch.float64).index_add_(
        0, torch.from_numpy(ids[keep]), torch.from_numpy(values[keep]))
    scale = float(np.abs(values).max()) * max(LONG)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0, atol=4e-7 * scale)
    assert torch.equal(got, _tree_reference(v, t_ids, n))
    counts = torch.from_numpy(np.round(values * 10)).float()
    assert torch.equal(layout.sum(counts), segment.segment_sum(counts, t_ids, n))


def test_tree_on_a_sorted_chunk():
    """`sorted_segments(..., tree=True)` of a slice of sorted rows sums that
    slice's part of each segment."""
    ids, values = _rows(LONG, (), seed=7, dropped=4)
    n = len(LONG)
    key = np.where((ids >= 0) & (ids < n), ids, n)
    order = np.argsort(key, kind="stable")
    key, v = torch.from_numpy(key[order]), torch.from_numpy(values[order])
    lo, hi = 100, len(key) - 5000
    k = key[lo:hi]
    seg = segment.sorted_segments(k, n, tree=True)
    assert len(seg.inner) == 1
    want = torch.zeros(n, dtype=torch.float64).index_add_(0, k[k < n], v[lo:hi][k < n])
    np.testing.assert_allclose(seg.sum(v[lo:hi]).numpy(), want.numpy(), rtol=1e-12, atol=1e-9)
