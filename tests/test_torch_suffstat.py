"""The scatter wrapper's row grouping and chunk schedule (`ops/suffstat.py`).

The CUDA kernel (`csrc/suffstat.cu`) runs one block per (chunk, output
tile) and trusts the schedule to hand every row of every cluster to
exactly one chunk, each chunk within one cluster; the schedule is plain
tensor code, so it is checked here on the CPU. The kernel itself is held
against float64 on the card in `tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

from common_tpu_torch.ops import suffstat as ss


def _offsets(sizes):
    off = np.zeros(len(sizes) + 1, np.int64)
    off[1:] = np.cumsum(sizes)
    return torch.tensor(off, dtype=torch.int32)


SCHEDULES = {
    "small and empty clusters": ([0, 5, 17, 0, 333, 1, 64], 16, 13),
    "one cluster": ([1000], 7, 0),
    "all empty": ([0, 0, 0], 8, 5),
    "exact multiples": ([32, 64, 96], 32, 0),
    "skewed, main-path-like": (list(np.random.default_rng(0).multinomial(
        100_000, np.r_[0.4, np.full(63, 0.6 / 63)])), 1024, 77),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_chunk_schedule_covers_every_row_once(case):
    sizes, rows, masked = SCHEDULES[case]
    K = len(sizes)
    offsets = _offsets(sizes)
    n_rows = int(offsets[-1]) + masked  # masked rows sort after every cluster
    cstart, lo, hi = ss.chunk_schedule(offsets, n_rows, rows)
    assert cstart.dtype == lo.dtype == hi.dtype == torch.int32
    assert lo.numel() == n_rows // rows + K
    cstart, lo, hi, off = (t.numpy().astype(np.int64) for t in (cstart, lo, hi, offsets))
    cover = np.zeros(n_rows, np.int64)
    for k in range(K):
        # cluster k's chunks are consecutive, in order, full but for the last
        us = range(cstart[k], cstart[k + 1])
        assert len(us) == -(-sizes[k] // rows)
        expect = off[k]
        for u in us:
            assert lo[u] == expect and lo[u] < hi[u] <= off[k + 1]
            assert hi[u] - lo[u] == rows or hi[u] == off[k + 1]
            cover[lo[u]:hi[u]] += 1
            expect = hi[u]
        assert expect == off[k + 1]
    assert (lo[cstart[K]:] == hi[cstart[K]:]).all()  # slots past the schedule are empty
    assert (cover[:off[K]] == 1).all() and (cover[off[K]:] == 0).all()


@pytest.mark.parametrize("n,D,K", [(1_000_000, 256, 64), (5_000_000, 384, 64), (1000, 20, 7),
                                   (10_000, 4096, 64)])
def test_rows_per_chunk_keeps_the_partials_in_scratch(n, D, K):
    rows = ss.rows_per_chunk(n, D, K)
    assert rows >= min(ss.ROWS_PER_CHUNK, n) and rows >= 1
    if K * D * D < ss.SCRATCH_FLOATS:
        assert (n // rows + K) * D * D <= ss.SCRATCH_FLOATS


def test_sort_by_cluster_is_a_stable_grouping():
    r = np.random.default_rng(1)
    z = r.integers(-2, 9, 5000).astype(np.int32)  # -2, -1 and 8 = K are masked
    order, offsets = ss.sort_by_cluster(torch.from_numpy(z), 8)
    zi = np.where((z >= 0) & (z < 8), z, 8)
    np.testing.assert_array_equal(order.numpy(), np.argsort(zi, kind="stable"))
    np.testing.assert_array_equal(offsets.numpy(), np.searchsorted(np.sort(zi), np.arange(9)))
    assert order.dtype == offsets.dtype == torch.int32
