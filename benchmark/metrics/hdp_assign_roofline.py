"""`hdp_assign_roofline`: HDP-LDA's score-and-assign stage (`topic/hdp.py` `_assign_docs`) against its roofline.

Device time: the kernels launched inside the benchmark's `hdp_assign` range
around `_assign_docs`, a call's worth (the [docs, L, K] score table, the
Gumbel noise, the argmax, the doc-topic counts and the topic-word count).
The stage's work, counted once whatever implements it, is bytes: per token
its word id (4 B) and mask (1 B) read and its z read and written (8 B);
theta read and doc_topic written ([D, K], 4 B each); log phi read and
topic_word written ([K, V], 4 B each). At 1M docs x 50 tokens, K = 32,
V = 10,000 that is 0.9086 GB, 0.2712 ms at 3.35 TB/s; its operations (an add
and a compare a score, 3.2 GFLOP) bind far below (6.5 us at 495 TFLOP/s).
"""

from benchmark.peaks import roofline_share

RANGE = "hdp_assign"


def flops(docs: int, doc_len: int, k: int, v: int) -> float:
    return 2.0 * docs * doc_len * k


def bytes_moved(docs: int, doc_len: int, k: int, v: int) -> float:
    tokens = docs * doc_len
    return (4.0 + 1.0 + 8.0) * tokens + 4.0 * 2 * docs * k + 4.0 * 2 * k * v


def read(ctx):
    r = ctx.ranges.get(RANGE)
    if ctx.peaks is None or not r or r["calls"] == 0 or r["device_s"] <= 0:
        return None
    s = ctx.shape
    return roofline_share(flops(s["docs"], s["doc_len"], s["k"], s["v"]),
                          bytes_moved(s["docs"], s["doc_len"], s["k"], s["v"]),
                          r["device_s"] / r["calls"], ctx.peaks)
