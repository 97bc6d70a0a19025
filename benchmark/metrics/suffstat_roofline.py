"""`suffstat_roofline`: the scatter matrices (`fused_scatter_stats`) against their roofline.

Device time: the kernels launched inside the benchmark's `suffstat` range
around the op's Python entry (its sort of the rows by slot included), a
call's worth. The work, counted once: sum_xxT[k] = sum of x x^T over the
rows in slot k, 2 N D^2 operations; bytes: X and z read once, the K D x D
matrices written once. At 1M x 256, K = 64 the bytes bind (0.312 ms at
3.35 TB/s against 0.265 ms of operations at 495 TFLOP/s).
"""

from benchmark.peaks import roofline_share

RANGE = "suffstat"


def flops(n: int, k: int, d: int) -> float:
    return 2.0 * n * d * d


def bytes_moved(n: int, k: int, d: int) -> float:
    return 4.0 * (n * d + n) + 4.0 * k * d * d


def read(ctx):
    r = ctx.ranges.get(RANGE)
    if ctx.peaks is None or not r or r["calls"] == 0 or r["device_s"] <= 0:
        return None
    s = ctx.shape
    return roofline_share(flops(s["n"], s["k"], s["d"]), bytes_moved(s["n"], s["k"], s["d"]),
                          r["device_s"] / r["calls"], ctx.peaks)
