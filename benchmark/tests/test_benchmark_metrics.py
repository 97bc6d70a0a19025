"""The per-layer metrics' counts, shares and the trace reduction, on hand-worked values."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import peaks, run
from benchmark.tracing import Event, reduce_events

H100 = peaks.peaks("NVIDIA H100 80GB HBM3")


def _module(name):
    return run.metric_reader(name).__globals__


def test_roofline_counts_at_a_small_shape():
    a = _module("assign_roofline")
    # 2 N K D^2 + 3 N K D; X, mu, B, base, seed read, z written (4 bytes each)
    assert a["flops"](10, 3, 4) == 2 * 10 * 3 * 16 + 3 * 10 * 3 * 4 == 1320
    assert a["bytes_moved"](10, 3, 4) == 4 * (40 + 12 + 48 + 3 + 1) + 4 * 10 == 456
    c = _module("assign_chains_roofline")
    assert c["flops"](10, 3, 4, 2) == 2 * 1320
    assert c["bytes_moved"](10, 3, 4, 2) == 4 * (40 + 2 * (12 + 48 + 3) + 1) + 4 * 2 * 10 == 748
    s = _module("suffstat_roofline")
    assert s["flops"](10, 3, 4) == 2 * 10 * 16 == 320
    assert s["bytes_moved"](10, 3, 4) == 4 * (40 + 10) + 4 * 3 * 16 == 392
    assert _module("mfu")["flops_per_chain_sweep"](10, 3, 4) == 960 + 320


def test_rooflines_at_the_headline_shape():
    """The bounds the metric files state: kernel 1 operation-bound at 17.05 ms,
    kernel 4 (C = 4) at 68.2 ms, kernel 2 byte-bound at 0.312 ms."""
    a, c, s = _module("assign_roofline"), _module("assign_chains_roofline"), _module("suffstat_roofline")
    n, k, d = 1_000_000, 64, 256
    assert a["flops"](n, k, d) / H100["tf32_flops"] == pytest.approx(17.05e-3, rel=1e-3)
    assert c["flops"](n, k, d, 4) / H100["tf32_flops"] == pytest.approx(68.2e-3, rel=1e-3)
    assert s["bytes_moved"](n, k, d) / H100["hbm_bytes_per_s"] == pytest.approx(0.3119e-3, rel=1e-3)
    assert s["flops"](n, k, d) / H100["tf32_flops"] < s["bytes_moved"](n, k, d) / H100["hbm_bytes_per_s"]


def _ctx(**kw):
    base = dict(ranges={}, busy_s=0.0, window_s=0.0, work=0, steps=0,
                shape={"n": 1_000_000, "d": 256, "k": 64, "chains": 1}, peaks=H100, device_name="x")
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_share_and_silence():
    read = run.metric_reader("assign_roofline")
    ctx = _ctx(ranges={"assign": {"device_s": 2 * 0.1, "launches": 2, "calls": 2}})
    flops = 2.0 * 1e6 * 64 * 256 * 256 + 3.0 * 1e6 * 64 * 256
    assert read(ctx) == pytest.approx(100 * flops / 495e12 / 0.1)
    assert read(_ctx()) is None  # nothing to read: no value, never 0
    assert read(_ctx(ranges=ctx.ranges, peaks=None)) is None
    mfu = run.metric_reader("mfu")
    per = 2.0 * 1e6 * 64 * 256 * 256 + 2.0 * 1e6 * 256 * 256
    assert mfu(_ctx(work=8, window_s=1.0)) == pytest.approx(100 * 8 * per / 495e12)
    assert mfu(_ctx(work=0, window_s=1.0)) is None
    idle = run.metric_reader("idle_share.sweep")
    assert idle(_ctx(busy_s=0.75, window_s=1.0)) == pytest.approx(25.0)
    assert idle(_ctx(busy_s=0.0, window_s=1.0)) is None
    launches = run.metric_reader("launches_per_iter")
    assert launches(_ctx(ranges={"slice_hp": {"device_s": 1.0, "launches": 300, "calls": 2}})) == 150


def test_reduce_events_attributes_by_launch():
    """Kernels go to the range their launch lies in, nested calls of a name
    count once, busy time is the union, gaps go to the innermost host event."""
    ev = [
        Event("sweep", False, 0, 100, annotation=True),
        Event("assign", False, 10, 40, annotation=True),
        Event("assign", False, 15, 30, annotation=True),  # nested call of the same name
        Event("aten::mm", False, 50, 60, corr=0),
        Event("cudaLaunchKernel", False, 20, 21, corr=7),
        Event("cudaLaunchKernel", False, 55, 56, corr=8),
        Event("cudaLaunchKernel", False, 150, 151, corr=9),
        Event("kernel_a", True, 25, 45, corr=7),
        Event("kernel_b", True, 44, 70, corr=8),
        Event("kernel_c", True, 160, 170, corr=9),
        Event("assign", True, 25, 45),  # the profiler's device-side copy of a range
    ]
    red = reduce_events(ev, 200e-6, ["sweep", "assign"])
    assert red.ranges["assign"] == {"device_s": 20e-6, "launches": 1, "calls": 2}
    assert red.ranges["sweep"]["launches"] == 2
    assert red.ranges["sweep"]["device_s"] == pytest.approx(46e-6)
    assert red.busy_s == pytest.approx((70 - 25 + 10) * 1e-6)
    assert red.device_ops[0] == ["kernel_b", pytest.approx(26e-6)]
    # the one gap, 70..160, has its middle at 115: no host event covers it
    assert red.idle_gaps == [["(host: Python between ops)", pytest.approx(90e-6)]]
