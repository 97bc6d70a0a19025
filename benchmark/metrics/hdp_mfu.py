"""`hdp_mfu`: HDP-LDA's whole iteration, its once-counted work over the traced window, as % of the HBM peak.

An iteration (a dense sweep and its CRT beta draw, with the runner's joint
score) is bound by bytes, counted once: score-and-assign's
(`hdp_assign_roofline.bytes_moved`), theta's draw written ([D, K]), the
CRT's read of doc_topic ([D, K]) and the joint score's reads of doc_topic and
topic_word ([D, K] and [K, V]), 4 B each: 1.2938 GB, 0.3862 ms at 3.35 TB/s
at 1M docs x 50 tokens, K = 32, V = 10,000. The work counts the sweeps
completed in the window, the time is the window's host clock: so it moves
with `sweeps_per_s`, and bounds the stages' rooflines. Named with `mfu` as
the whole iteration's share of the card's peak, here its bandwidth.
"""

from benchmark import run


def bytes_per_sweep(docs: int, doc_len: int, k: int, v: int) -> float:
    assign = run.metric_reader("hdp_assign_roofline").__globals__["bytes_moved"]
    return assign(docs, doc_len, k, v) + 4.0 * 3 * docs * k + 4.0 * k * v


def read(ctx):
    if ctx.peaks is None or ctx.window_s <= 0 or ctx.work <= 0:
        return None
    s = ctx.shape
    done = bytes_per_sweep(s["docs"], s["doc_len"], s["k"], s["v"]) * ctx.work
    return 100.0 * done / (ctx.window_s * ctx.peaks["hbm_bytes_per_s"])
