"""`irm_table_roofline`: the IRM's blocked tables (`relational/kernels.py` `_domain_loglik_table`) against their roofline.

Device time: the kernels launched inside the benchmark's `irm_table` range
around `_domain_loglik_table`, both domains' calls of a sweep (each gathers
theta for every cell and candidate, takes the Bernoulli log density and sums
it by entity in chunks of cells). The stage's work, counted once whatever
implements it, is bytes: a domain reads each cell's two entity ids (4 B
each), its value and its mask (1 B each) and the other domain's z (4 B an
entity), and writes its [N_d, K] table (4 B an entry). At 4096 x 4096 cells
and K = 32 that is 0.3366 GB a sweep, 0.1005 ms at 3.35 TB/s; its operations
(a multiply and an add a cell and candidate, 2.15 GFLOP a sweep) bind far
below (4.3 us at 495 TFLOP/s).
"""

from benchmark.peaks import roofline_share

RANGE = "irm_table"
CELL_BYTES = 4.0 + 4.0 + 1.0 + 1.0  # two entity ids, the value, the mask


def flops(n0: int, n1: int, k: int) -> float:
    return 2.0 * 2 * n0 * n1 * k


def bytes_moved(n0: int, n1: int, k: int) -> float:
    """Both domains' tables of a sweep."""
    cells = n0 * n1
    return sum(CELL_BYTES * cells + 4.0 * n_d * k + 4.0 * n_other for n_d, n_other in ((n0, n1), (n1, n0)))


def read(ctx):
    r = ctx.ranges.get(RANGE)
    if ctx.peaks is None or not r or r["calls"] == 0 or r["device_s"] <= 0:
        return None
    s = ctx.shape
    per_sweep = r["device_s"] / (r["calls"] / 2)  # a call a domain
    return roofline_share(flops(s["n0"], s["n1"], s["k"]), bytes_moved(s["n0"], s["n1"], s["k"]), per_sweep,
                          ctx.peaks)
