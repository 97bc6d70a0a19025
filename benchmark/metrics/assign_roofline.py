"""`assign_roofline`: the Gaussian assignment (`fused_gaussian_assign`) against its roofline.

Device time: the kernels launched inside the benchmark's `assign` range
around the op's Python entry, a call's worth. The algorithm's work, counted
once whatever implements it: 2 N K D^2 operations for the K products
B_k (x_n - mu_k), and 3 N K D for the difference, the square and the sum;
bytes: X, mu, B, base and the seed read once, z written once. At 1M x 256,
K = 64 the operations bind (17.05 ms at 495 TFLOP/s against 0.31 ms of
bytes at 3.35 TB/s).
"""

from benchmark.peaks import roofline_share

RANGE = "assign"


def flops(n: int, k: int, d: int) -> float:
    return 2.0 * n * k * d * d + 3.0 * n * k * d


def bytes_moved(n: int, k: int, d: int) -> float:
    return 4.0 * (n * d + k * d + k * d * d + k + 1) + 4.0 * n


def read(ctx):
    r = ctx.ranges.get(RANGE)
    if ctx.peaks is None or not r or r["calls"] == 0 or r["device_s"] <= 0:
        return None
    s = ctx.shape
    return roofline_share(flops(s["n"], s["k"], s["d"]), bytes_moved(s["n"], s["k"], s["d"]),
                          r["device_s"] / r["calls"], ctx.peaks)
