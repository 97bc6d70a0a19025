"""The IRM cell (`irm_bb_4096.blocked`): its checks, planted faults and readers, on the CPU.

A tiny copy of the cell (256 x 256 cells in the cell's 8 x 8 planted
blocks, its K_max of 32) runs whole on the CPU: set-up, window, comparison.
Its statistics read about abs(N(0, 1)) there as at the cell's size, so the
cell's limits hold them; the control's bfloat16 tables and joint score fail
`table_gap` and `score_gap` at any size.
"""

from __future__ import annotations

import copy
import dataclasses
from types import SimpleNamespace

import pytest
import torch

from benchmark import run

CELL = "irm_bb_4096.blocked"
CPU = torch.device("cpu")
SEED = 2**31 + 2525
TINY = {"domains": [256, 256]}


def tiny_spec():
    spec = copy.deepcopy(run.cell_spec(CELL))
    spec.config.update(TINY)
    return spec


def _run(modes=("program",), seconds=0.3, trace=False):
    return run.run_cell(tiny_spec(), SEED, seconds, trace, CPU, modes)


def _caught(out, name):
    value = out["checks"][name]["value"]
    return value == "inf" or value > out["checks"][name]["limit"]


def test_sound_run_is_correct_on_the_cpu():
    out = _run()
    assert out["correct"], out["checks"]
    got = out["readings"]["program"]
    assert got["irm_counts"] == 0 and got["stick_counts"] == 0
    assert out["attempted"] >= 1


def test_control_is_not_correct_on_the_cpu():
    out = _run(modes=("control",))
    assert not out["correct"], out["checks"]
    assert _caught(out, "table_gap") and _caught(out, "score_gap"), out["checks"]


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------
def _unchanged(state, views, generator):
    """A blocked sweep that returns its state."""
    return state


def _stale_row_z(kernels):
    """The column table built from the row z the sweep started from."""
    theta, table = kernels._sample_block_params, kernels._domain_loglik_table
    start = {}

    def keep(state, generator):
        start["z0"] = state.assignments[0]
        return theta(state, generator)

    def stale(state, views, thetas, domain):
        if domain == 1:
            state = dataclasses.replace(state, assignments=(start["z0"], state.assignments[1]))
        return table(state, views, thetas, domain)

    return {"_sample_block_params": keep, "_domain_loglik_table": stale}


def _theta_from_prior(state, generator):
    return tuple(lik.sample_params(generator, hyper, {k: torch.zeros_like(v) for k, v in stats.items()})
                 for lik, hyper, stats in zip(state.likelihoods(), state.hypers, state.suffstats))


def _alpha_doubled(state, generator):
    return tuple(lik.sample_params(generator, {**hyper, "alpha": 2.0 * hyper["alpha"]}, stats)
                 for lik, hyper, stats in zip(state.likelihoods(), state.hypers, state.suffstats))


def _half_restat(fn):
    """A restat over the first half of the cells only."""
    from common_tpu_torch import relational

    def wrapped(state, views):
        views = relational.as_views(views)
        first = [torch.arange(v.mask.shape[0], device=v.mask.device) < v.mask.shape[0] // 2 for v in views]
        return fn(state, [relational.RelView(v.indices, v.values, v.mask * f) for v, f in zip(views, first)])
    return wrapped


FAULTS = {"unchanged": "assign_fit_t", "stale_row_z": "table_gap", "theta_from_prior": "theta_t",
          "alpha_doubled": "theta_t", "half_restat": "irm_counts"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    """Each planted fault fails the comparison, by the number that judges its stage."""
    from common_tpu_torch.relational import kernels

    if fault == "unchanged":
        monkeypatch.setattr(kernels, "sweep", _unchanged)
    elif fault == "stale_row_z":
        for name, fn in _stale_row_z(kernels).items():
            monkeypatch.setattr(kernels, name, fn)
    elif fault == "theta_from_prior":
        monkeypatch.setattr(kernels, "_sample_block_params", _theta_from_prior)
    elif fault == "alpha_doubled":
        monkeypatch.setattr(kernels, "_sample_block_params", _alpha_doubled)
    else:
        monkeypatch.setattr(kernels, "restat", _half_restat(kernels.restat))
    out = _run()
    assert not out["correct"], out["checks"]
    assert _caught(out, FAULTS[fault]), out["checks"]


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------
def _module(name):
    return run.metric_reader(name).__globals__


H100 = {"tf32_flops": 495e12, "hbm_bytes_per_s": 3.35e12}
SHAPE = {"n0": 4096, "n1": 4096, "k": 32, "cells": 4096 * 4096}


def test_counts_at_a_small_shape():
    t, r, m = _module("irm_table_roofline"), _module("irm_restat_roofline"), _module("irm_mfu")
    # 3 x 5 cells, K 2: 10 B a cell each domain, the other domain's z, each table written
    assert t["bytes_moved"](3, 5, 2) == 2 * 10 * 15 + (4 * 3 * 2 + 4 * 5) + (4 * 5 * 2 + 4 * 3) == 396
    assert t["flops"](3, 5, 2) == 2 * 2 * 15 * 2
    assert r["bytes_moved"](3, 5, 2) == 10 * 15 + 4 * 8 + 4 * 2 * 2 * 2 == 214
    assert m["bytes_per_sweep"](3, 5, 2) == 396 + 214


def test_bounds_at_the_cells_shape():
    """The bounds the metric files state: 0.3366 GB (0.1005 ms), 0.1678 GB (0.0501 ms) and
    0.5044 GB (0.1506 ms) a sweep, bytes binding."""
    t, r, m = _module("irm_table_roofline"), _module("irm_restat_roofline"), _module("irm_mfu")
    n, k = 4096, 32
    assert t["bytes_moved"](n, n, k) == pytest.approx(0.3366e9, rel=1e-3)
    assert t["bytes_moved"](n, n, k) / H100["hbm_bytes_per_s"] == pytest.approx(0.1005e-3, rel=1e-3)
    assert t["flops"](n, n, k) == pytest.approx(2.15e9, rel=1e-2)
    assert t["flops"](n, n, k) / H100["tf32_flops"] < 0.05 * t["bytes_moved"](n, n, k) / H100["hbm_bytes_per_s"]
    assert r["bytes_moved"](n, n, k) / H100["hbm_bytes_per_s"] == pytest.approx(0.0501e-3, rel=1e-3)
    assert m["bytes_per_sweep"](n, n, k) == pytest.approx(0.5044e9, rel=1e-3)


def _ctx(**kw):
    base = dict(ranges={}, busy_s=0.0, window_s=0.0, work=0, steps=0, shape=dict(SHAPE), peaks=H100, device_name="x")
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_share_and_silence():
    t, r = _module("irm_table_roofline"), _module("irm_restat_roofline")
    table = run.metric_reader("irm_table_roofline")
    bound = t["bytes_moved"](4096, 4096, 32) / 3.35e12
    # 8 sweeps, two calls a sweep, 42.1 ms of device time a sweep
    ctx = _ctx(ranges={"irm_table": {"device_s": 8 * 0.0421, "launches": 3000, "calls": 16}})
    assert table(ctx) == pytest.approx(100 * bound / 0.0421)
    assert table(_ctx()) is None and table(_ctx(ranges=ctx.ranges, peaks=None)) is None
    restat = run.metric_reader("irm_restat_roofline")
    got = restat(_ctx(ranges={"irm_restat": {"device_s": 8 * 0.00413, "launches": 400, "calls": 8}}))
    assert got == pytest.approx(100 * r["bytes_moved"](4096, 4096, 32) / 3.35e12 / 0.00413)
    assert restat(_ctx(ranges={"irm_restat": {"device_s": 0.0, "launches": 0, "calls": 0}})) is None
    mfu = run.metric_reader("irm_mfu")
    per = _module("irm_mfu")["bytes_per_sweep"](4096, 4096, 32)
    assert mfu(_ctx(work=8, window_s=0.4)) == pytest.approx(100 * 8 * per / 0.4 / 3.35e12)
    assert mfu(_ctx(work=0, window_s=0.4)) is None


def test_the_trace_ranges_of_the_tiny_cell():
    """A traced step opens the cell's ranges: a sweep a step's sweep, the
    table a domain a sweep, the restat a sweep. The CPU run has no device
    time, so the rooflines are silent there."""
    out = _run(seconds=0.2, trace=True)
    ranges = out["trace"].ranges
    sweeps = run.cell_spec(CELL).workload["chunk"]
    assert ranges["sweep"]["calls"] == ranges["irm_restat"]["calls"] == sweeps
    assert ranges["irm_table"]["calls"] == 2 * sweeps
    assert "irm_table_roofline" not in out["metrics"] and "irm_restat_roofline" not in out["metrics"]
    assert out["correct"], out["checks"]


def test_the_reference_imports_nothing_of_the_program():
    from benchmark.tests.test_benchmark_imports import FORBIDDEN, _imported

    names = _imported("import benchmark.reference.irm")
    assert not names & (FORBIDDEN | {"common_tpu_torch"}), names
