"""`irm_mfu`: the IRM's whole blocked sweep, its once-counted work over the traced window, as % of the HBM peak.

A sweep (theta's draw, both domains' tables and draws, the restat, with the
runner's joint score) is bound by bytes, counted once: both tables'
(`irm_table_roofline.bytes_moved`) and the restat's
(`irm_restat_roofline.bytes_moved`); theta's draw, the stick weights, the
draws and the score touch [K, K] and [N_d, K] tensors, which are left out.
0.5044 GB, 0.1506 ms at 3.35 TB/s at 4096 x 4096 cells and K = 32. The work
counts the sweeps completed in the window, the time is the window's host
clock: so it moves with `sweeps_per_s`, and bounds the stages' rooflines.
Named with `mfu` as the whole sweep's share of the card's peak, here its
bandwidth.
"""

from benchmark import run


def bytes_per_sweep(n0: int, n1: int, k: int) -> float:
    return sum(run.metric_reader(name).__globals__["bytes_moved"](n0, n1, k)
               for name in ("irm_table_roofline", "irm_restat_roofline"))


def read(ctx):
    if ctx.peaks is None or ctx.window_s <= 0 or ctx.work <= 0:
        return None
    s = ctx.shape
    done = bytes_per_sweep(s["n0"], s["n1"], s["k"]) * ctx.work
    return 100.0 * done / (ctx.window_s * ctx.peaks["hbm_bytes_per_s"])
