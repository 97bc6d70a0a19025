"""`mfu`: the sweep's useful work over the traced window, as % of the TF32 peak.

A chain-sweep of an N x D table with K slots does 2 N K D^2 useful
operations in scoring (each row against each slot's D x D factor) and
2 N D^2 in the restat's scatter matrices; against 495 TFLOP/s, the H100's
dense TF32 tensor-core rate. The work counts chain-sweeps completed in the
window (C a sweep on path A), the time is the window's host clock: so it
moves with `sweeps_per_s`, and bounds every kernel roofline of the sweep.
"""


def flops_per_chain_sweep(n: int, k: int, d: int) -> float:
    return 2.0 * n * k * d * d + 2.0 * n * d * d


def read(ctx):
    if ctx.peaks is None or ctx.window_s <= 0 or ctx.work <= 0:
        return None
    s = ctx.shape
    done = flops_per_chain_sweep(s["n"], s["k"], s["d"]) * ctx.work
    return 100.0 * done / (ctx.window_s * ctx.peaks["tf32_flops"])
