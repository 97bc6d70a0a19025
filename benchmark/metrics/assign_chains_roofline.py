"""`assign_chains_roofline`: the multi-chain assignment (`fused_gaussian_assign_chains`) against its roofline.

Device time: the kernels launched inside the benchmark's `assign_chains`
range, a call's worth. The work, counted once: C chains of 2 N K D^2 + 3 N K D
operations (as `assign_roofline`); bytes: X read once for all chains, each
chain's mu, B and base read once, z [C, N] written once. At 1M x 256, K = 64,
C = 4 the operations bind (68.2 ms at 495 TFLOP/s).
"""

from benchmark.peaks import roofline_share

RANGE = "assign_chains"


def flops(n: int, k: int, d: int, c: int) -> float:
    return c * (2.0 * n * k * d * d + 3.0 * n * k * d)


def bytes_moved(n: int, k: int, d: int, c: int) -> float:
    return 4.0 * (n * d + c * (k * d + k * d * d + k) + 1) + 4.0 * c * n


def read(ctx):
    r = ctx.ranges.get(RANGE)
    if ctx.peaks is None or not r or r["calls"] == 0 or r["device_s"] <= 0:
        return None
    s = ctx.shape
    return roofline_share(flops(s["n"], s["k"], s["d"], s["chains"]),
                          bytes_moved(s["n"], s["k"], s["d"], s["chains"]),
                          r["device_s"] / r["calls"], ctx.peaks)
