"""`irm_restat_roofline`: the IRM's suffstat rebuild (`relational/kernels.py` `restat`) against its roofline.

Device time: the kernels launched inside the benchmark's `irm_restat` range
around `restat`, a call (both domains' counts and the relation's (n, heads)
block stats by a sorted segment sum over the cells in chunks). Its work,
counted once, is bytes: each cell's two entity ids (4 B each), value and
mask (1 B each), both domains' z (4 B an entity) and the two [K, K] stats
written (4 B an entry). At 4096 x 4096 cells and K = 32 that is 0.1678 GB,
0.0501 ms at 3.35 TB/s; its operations (two adds a cell) bind far below.
"""

from benchmark.peaks import roofline_share

RANGE = "irm_restat"
CELL_BYTES = 4.0 + 4.0 + 1.0 + 1.0


def flops(n0: int, n1: int, k: int) -> float:
    return 2.0 * n0 * n1


def bytes_moved(n0: int, n1: int, k: int) -> float:
    return CELL_BYTES * n0 * n1 + 4.0 * (n0 + n1) + 4.0 * 2 * k * k


def read(ctx):
    r = ctx.ranges.get(RANGE)
    if ctx.peaks is None or not r or r["calls"] == 0 or r["device_s"] <= 0:
        return None
    s = ctx.shape
    return roofline_share(flops(s["n0"], s["n1"], s["k"]), bytes_moved(s["n0"], s["n1"], s["k"]),
                          r["device_s"] / r["calls"], ctx.peaks)
