"""`crt_roofline`: HDP-LDA's table-count draw (`topic/hdp.py` `crt_sample`) against its roofline.

Device time: the kernels launched inside the benchmark's `crt` range around
`crt_sample`, a call's worth (one call a sweep, from `sample_beta`). The
work, counted once: m_dk ~ CRT(n_dk, alpha beta_k) needs doc_topic read once
([D, K], 4 B each) and gives the K table counts (4 B each); bytes bind. At
1M docs, K = 32 that is 0.128 GB, 0.0382 ms at 3.35 TB/s. The draw's
Bernoulli batches, one for each i below the longest document, are the
implementation's, not the work's.
"""

from benchmark.peaks import roofline_share

RANGE = "crt"


def flops(docs: int, k: int) -> float:
    return 0.0


def bytes_moved(docs: int, k: int) -> float:
    return 4.0 * docs * k + 4.0 * k


def read(ctx):
    r = ctx.ranges.get(RANGE)
    if ctx.peaks is None or not r or r["calls"] == 0 or r["device_s"] <= 0:
        return None
    s = ctx.shape
    return roofline_share(flops(s["docs"], s["k"]), bytes_moved(s["docs"], s["k"]),
                          r["device_s"] / r["calls"], ctx.peaks)
