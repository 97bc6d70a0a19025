#!/usr/bin/env python3
"""Design probes of the order-fixed segment sum (`common_tpu_torch.utils.segment`)
on one CUDA card.

    python3 scripts/segment_probes.py

1. The IRM's blocked table on `chip_smoke.py`'s phase 11 relation (4096 x
   4096 Beta-Bernoulli, K_max=32), each chunk's rows cut into pieces from
   each entity's start (the shipped layout) and on a global grid of PIECE
   rows (a local copy of that alternative), in turns: ms a table, ms to sum
   one chunk, and whether the two layouts' tables agree to float32.
2. A chunk's cell indices gathered from a row-major and from a column-major
   [M, 2] int64 tensor: `index_select` of rows against a column at a time.
3. Host time of one small layout and sum, at the collapsed IRM step's size
   (30 rows into 192 segments): `segments`, `Segments.sum` and their parts.

Times are CUDA events over back-to-back calls (`chip_smoke.cuda_ms`), host
times a wall clock over 200 calls ending in a synchronize. The first line
is the card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import BLOCKS11, K11, N11, SEED, card_line, cuda_ms, irm_blocks  # noqa: E402


def _grid_segments(ids, n):
    """The alternative layout: sorted rows cut at every segment's start and
    at every PIECE-th row of the whole chunk."""
    import torch

    from common_tpu_torch.utils.segment import PIECE, Segments

    start = torch.searchsorted(ids, torch.arange(n + 1, device=ids.device, dtype=ids.dtype))
    pieces = torch.sort(torch.cat([start, torch.arange(0, ids.shape[0], PIECE, device=ids.device)])).values
    return Segments(None, pieces, torch.searchsorted(pieces, start), n)


def _host_us(fn, reps: int = 200) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def main() -> int:
    import torch

    from common_tpu_torch import models, rng
    from common_tpu_torch import relational as irm
    from common_tpu_torch.data import sparse_ndarray_dataview
    from common_tpu_torch.relational import kernels as rk
    from common_tpu_torch.utils import segment

    if not torch.cuda.is_available():
        print("segment_probes: needs a CUDA card", file=sys.stderr)
        return 1
    print(card_line())
    dev = torch.device("cuda")
    rel, _ = irm_blocks(N11, BLOCKS11, SEED)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device=dev)])
    view = views[0]
    defn = irm.model_definition([N11, N11], [((0, 1), models.bb)], k_max=K11)
    s = irm.initialize(defn, views, rng(1, dev).generator, cluster_hps=[{"alpha": 1.0}] * 2)
    theta = rk._sample_block_params(s, rng(2, dev).generator)
    chunk = rk.TABLE_ELEMS // K11

    # 1. the two piece layouts, in turns
    layouts = {}
    for name, build in (("start", segment.sorted_segments), ("grid", _grid_segments)):
        layouts[name] = {}
        for axis in (0, 1):
            ent = torch.where(view.mask > 0, view.indices[:, axis], N11).to(torch.int32)
            ent, order = torch.sort(ent, stable=True)
            m = ent.shape[0]
            layouts[name][axis] = (order.to(torch.int32), [(lo, min(m, lo + chunk), build(ent[lo:lo + chunk], N11))
                                                           for lo in range(0, m, chunk)])
    lp = torch.randn(chunk, K11, device=dev)
    tables = {}
    for name in ("start", "grid", "grid", "start"):
        row = []
        for axis in (0, 1):
            view.cell_orders[((0, 1), axis, N11, chunk)] = layouts[name][axis]
            seg = layouts[name][axis][1][3][2]
            row.append((cuda_ms(lambda a=axis: rk._domain_loglik_table(s, views, theta, a), 5),
                        cuda_ms(lambda: seg.sum(lp), 20)))
            tables.setdefault(name, {})[axis] = rk._domain_loglik_table(s, views, theta, axis)
        print(f"pieces from {name:5s}: tables {row[0][0]:.2f} / {row[1][0]:.2f} ms, one chunk's sum "
              f"{row[0][1]:.3f} / {row[1][1]:.3f} ms")
    agree = all(torch.allclose(tables["start"][a], tables["grid"][a], rtol=1e-5, atol=1e-3) for a in (0, 1))
    print(f"the two layouts' tables agree to float32 rounding: {agree}")
    view.cell_orders.clear()

    # 2. gathering a chunk's indices from either memory layout
    order, chunks = rk._table_layout(view, (0, 1), 1, N11, chunk)
    cells = order[chunks[3][0]:chunks[3][1]]
    for name, idx in (("column-major", view.indices), ("row-major", view.indices.contiguous())):
        rows_ms = cuda_ms(lambda: idx.index_select(0, cells), 20)
        cols_ms = cuda_ms(lambda: idx.t().index_select(1, cells).t(), 20)
        print(f"{name} [M, 2] int64, {cells.shape[0]} cells: index_select of rows {rows_ms:.3f} ms, "
              f"a column at a time {cols_ms:.3f} ms")

    # 3. host time at the collapsed step's size
    ids = torch.randint(0, 192, (30,), device=dev, generator=rng(3, dev).generator)
    t = torch.randn(30, device=dev)
    seg = segment.segments(ids, 192)
    for name, fn in (("segment_sum", lambda: segment.segment_sum(t, ids, 192)),
                     ("segments()", lambda: segment.segments(ids, 192)), ("Segments.sum", lambda: seg.sum(t)),
                     ("stable sort", lambda: torch.sort(ids.to(torch.int32), stable=True)),
                     ("segment_reduce", lambda: torch.segment_reduce(t[:, None], "sum", offsets=seg.pieces,
                                                                     unsafe=True)),
                     ("an add", lambda: t + t)):
        print(f"30 rows into 192 segments, {name}: {_host_us(fn):.1f} us a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
