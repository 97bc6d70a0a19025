"""The metrics that read the program's own record, and the record's run, on the CPU."""

from __future__ import annotations

import pytest
import torch

from benchmark import program_record, run
from benchmark.tests.conftest import tiny_spec
from benchmark.tracing import Event

CPU = torch.device("cpu")
SEED = 2**31 + 4242


def _rec(**kw):
    base = {"window_s": 2.0, "counters": {}, "reads": {}, "block_reads": {}, "spans": {}}
    base.update(kw)
    return base


HAND = _rec(
    window_s=4.0,
    spans={"runner.step": {"calls": 2, "host_s": 3.5, "self_s": 0.1},
           "smc.block_step": {"calls": 4, "host_s": 2.0, "self_s": 0.2},
           "read.slice.step_out": {"calls": 600, "host_s": 0.6, "self_s": 0.6},
           "read.smc.ess": {"calls": 5, "host_s": 0.2, "self_s": 0.2},
           "slice.update": {"calls": 258, "host_s": 3.0, "self_s": 1.0}},
    reads={"slice.step_out": 600, "smc.ess": 5},
    block_reads={"smc.ess": 4, "x.y": 2},
)


def test_readers_on_a_hand_worked_record(monkeypatch):
    monkeypatch.setattr(program_record, "record", lambda: HAND)
    assert run.metric_reader("host_reads_per_iter")(None) == (600 + 5) / 2
    assert run.metric_reader("host_reads_per_block")(None) == (4 + 2) / 4
    # 0.6 s + 0.2 s of reads over a 4 s window, whichever rate the name moves
    assert run.metric_reader("read_wait_share.iter")(None) == pytest.approx(20.0)
    assert run.metric_reader("read_wait_share.smc")(None) == pytest.approx(20.0)


@pytest.mark.parametrize("rec", [None, _rec(), _rec(window_s=0.0)])
def test_readers_are_silent_without_a_record(monkeypatch, rec):
    monkeypatch.setattr(program_record, "record", lambda: rec)
    for name in ("host_reads_per_iter", "host_reads_per_block", "read_wait_share.smc"):
        value = run.metric_reader(name)(None)
        assert value is None or (rec and rec["window_s"] > 0 and value == 0.0), name


def test_record_starts_nothing_without_a_cell_or_a_recorder(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("no child may start")

    monkeypatch.setattr(program_record.subprocess, "run", refuse)
    assert program_record.record(["-q", "tests"]) is None
    assert program_record.record(["--workload", "dpmm_niw_1m_d256.smc"]) is None
    monkeypatch.setattr(program_record, "profiling_module", lambda: None)
    assert program_record.record(["--workload", "dpmm_niw_1m_d256.smc", "--seed", "5"]) is None


def test_idle_by_span_takes_the_innermost_program_span():
    ev = [
        Event("smc.block_step", False, 0, 100, annotation=True),
        Event("read.smc.ess", False, 60, 80, annotation=True),
        Event("aten::item", False, 61, 79),
        Event("smc.block_step", True, 0, 100),  # a device-side copy of the range: not device work
        Event("k1", True, 0, 10),
        Event("k2", True, 20, 30),  # gap 10..20, middle 15: in block_step only
        Event("k3", True, 90, 95),  # gap 30..90, middle 60: in the read
        Event("k4", True, 150, 160),  # gap 95..150, middle 122.5: outside every span
    ]
    out = dict(program_record.idle_by_span(ev, {"smc.block_step", "read.smc.ess"}))
    assert out == {"read.smc.ess": pytest.approx(60e-6), "smc.block_step": pytest.approx(10e-6),
                   program_record.OUTSIDE: pytest.approx(55e-6)}


@pytest.mark.parametrize("cell", ["dpmm_bbv_100k_d64.slice_hp", "dpmm_niw_1m_d256.smc"])
def test_the_record_of_a_tiny_cell(cell, monkeypatch):
    """The child's work, in this process on the CPU at a test's size: the
    recorded step and the profiled traced step, and the readers on it."""
    spec = tiny_spec(cell)
    out = program_record.measure(spec, SEED, CPU)
    assert out["window_s"] > 0 and "idle_spans" not in out
    reads = sum(out["reads"].values())
    monkeypatch.setattr(program_record, "record", lambda: out)
    if cell.endswith("slice_hp"):
        assert out["spans"]["runner.step"]["calls"] == 1
        assert out["reads"]["slice.step_out"] >= 2 * (2 * spec.config["d"] + 1) and out["reads"]["runner.trace"] == 1
        assert run.metric_reader("host_reads_per_iter")(None) == reads
        assert out["counters"]["slice.evals"] > out["reads"]["slice.step_out"]
    else:
        blocks = out["spans"]["smc.block_step"]["calls"]
        assert blocks == -(-(spec.config["n"] - spec.workload["warmup_rows"]) // spec.workload["block"])
        assert out["block_reads"] == {"smc.ess": blocks}
        assert run.metric_reader("host_reads_per_block")(None) == 1.0
    share = run.metric_reader("read_wait_share.iter")(None)
    assert 0 < share < 100
    # the same seed gives the same reads
    assert program_record.measure(spec, SEED, CPU)["reads"] == out["reads"]
    assert program_record.measure(spec, SEED, CPU, profile=True)["idle_spans"] == []  # no device on the CPU
