"""The HDP-LDA cell (`hdp_lda_1m_docs.dense`): its checks, planted faults, readers and record, on the CPU.

A tiny copy of the cell (4,000 docs of the cell's 50 tokens, V 2,000 in its
4 planted blocks, K 6) runs whole on the CPU: set-up, window, comparison.
Its statistics read about abs(N(0, 1)) there as at the cell's size, so the
cell's limits hold them; the control's bfloat16 joint score fails
`score_gap` at any size (its bfloat16 draw fails `assign_fit_t` only where
the cells hold many tokens: on the card, `test_control_is_not_correct_at_the_cells_size`).
"""

from __future__ import annotations

import copy
import math

import pytest
import torch

from benchmark import program_record, run

CELL = "hdp_lda_1m_docs.dense"
CPU = torch.device("cpu")
SEED = 2**31 + 2121
TINY = {"n_docs": 4000, "doc_len": 50, "vocab": 2000, "k_topics": 6}


def tiny_spec(**hyper):
    """The cell cut to TINY, warmed up for 8 sweeps: by then the docs hold one
    or two topics each, as the cell's do after its 2 (the CRT and phi faults
    show only on such docs, and a short window on a loaded CPU may hold a
    single step)."""
    spec = copy.deepcopy(run.cell_spec(CELL))
    spec.config.update(TINY)
    spec.config["hyper"].update(hyper)
    spec.workload["kernels"][0][1]["doc_chunk"] = 1000
    spec.workload["warmup"] = 8
    return spec


def _run(spec=None, modes=("program",), seconds=0.5):
    return run.run_cell(spec or tiny_spec(), SEED, seconds, False, CPU, modes)


def _caught(out, name):
    value = out["checks"][name]["value"]
    return value == "inf" or value > out["checks"][name]["limit"]


def test_sound_run_is_correct_on_the_cpu():
    out = _run()
    assert out["correct"], out["checks"]
    got = out["readings"]["program"]
    assert got["hdp_counts"] == 0 and got["held_z"] == 0
    assert out["attempted"] >= 1


def test_control_is_not_correct_on_the_cpu():
    out = _run(modes=("control",))
    assert not out["correct"], out["checks"]
    assert _caught(out, "score_gap")


def _unchanged(state, *args, **kwargs):
    """A dense sweep that returns its state."""
    return state


def _chunk_left(fn):
    """The docs' assignment with its last chunk of docs left at their old z
    (their counts made consistent with it)."""
    from common_tpu_torch.topic import hdp

    def wrapped(state, words, mask, phi, theta, generator, doc_chunk):
        z, dk, kw = fn(state, words, mask, phi, theta, generator, doc_chunk)
        D, L = words.shape
        z = z.clone()
        z.view(D, L)[D - doc_chunk:] = state.z.view(D, L)[D - doc_chunk:]
        dk, kw, _ = hdp._counts(z, hdp.dense_token_data(words, mask), D, state.n_topics, state.vocab_size)
        return z, dk, kw
    return wrapped


def _eta_doubled(state, generator):
    from common_tpu_torch.topic import hdp

    return hdp._dirichlet(state.topic_word + 2.0 * state.hypers["eta"], generator)


def _crt_capped(fn):
    def wrapped(generator, counts, conc, max_count):
        return fn(generator, counts, conc, min(int(max_count), 25))
    return wrapped


def _gamma_tenfold(fn):
    def wrapped(m_k, gamma, generator):
        return fn(m_k, 10.0 * gamma, generator)
    return wrapped


FAULTS = {"unchanged": "assign_fit_t", "chunk_left": "assign_fit_t", "eta_doubled": "phi_t",
          "crt_capped": "crt_t", "gamma_tenfold": "beta_t"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    """Each planted fault fails the comparison, by the number that judges its stage."""
    from common_tpu_torch.topic import hdp

    spec = tiny_spec()
    if fault == "unchanged":
        monkeypatch.setattr(hdp, "blocked_sweep_dense", _unchanged)
    elif fault == "chunk_left":
        monkeypatch.setattr(hdp, "_assign_docs", _chunk_left(hdp._assign_docs))
    elif fault == "eta_doubled":
        monkeypatch.setattr(hdp, "_draw_phi", _eta_doubled)
    elif fault == "gamma_tenfold":
        monkeypatch.setattr(hdp, "_beta_from_tables", _gamma_tenfold(hdp._beta_from_tables))
    else:
        # alpha 5: more tables a long document, so 2,000 docs a topic show the lost ones
        spec = tiny_spec(alpha=5.0)
        monkeypatch.setattr(hdp, "crt_sample", _crt_capped(hdp.crt_sample))
    out = _run(spec)
    assert not out["correct"], out["checks"]
    assert _caught(out, FAULTS[fault]), out["checks"]


def test_sound_run_at_the_faults_sizes_is_correct():
    """The crt fault's alpha alone does not fail the comparison."""
    out = _run(tiny_spec(alpha=5.0))
    assert out["correct"], out["checks"]


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------
def _module(name):
    return run.metric_reader(name).__globals__


H100 = {"tf32_flops": 495e12, "hbm_bytes_per_s": 3.35e12}
SHAPE = {"docs": 1_000_000, "doc_len": 50, "v": 10_000, "k": 32}


def test_counts_at_a_small_shape():
    a = _module("hdp_assign_roofline")
    # 3 docs x 4 tokens, K 2, V 5: 13 B a token, theta and doc_topic, log phi and topic_word
    assert a["bytes_moved"](3, 4, 2, 5) == 13 * 12 + 4 * 2 * 3 * 2 + 4 * 2 * 2 * 5 == 284
    assert a["flops"](3, 4, 2, 5) == 2 * 12 * 2
    c = _module("crt_roofline")
    assert c["bytes_moved"](3, 2) == 4 * 6 + 4 * 2 and c["flops"](3, 2) == 0
    m = _module("hdp_mfu")
    assert m["bytes_per_sweep"](3, 4, 2, 5) == 284 + 4 * 3 * 3 * 2 + 4 * 2 * 5


def test_bounds_at_the_cells_shape():
    """The bounds the metric files state: 0.2712, 0.0382 and 0.3862 ms, bytes binding."""
    a, c, m = _module("hdp_assign_roofline"), _module("crt_roofline"), _module("hdp_mfu")
    d, L, v, k = SHAPE["docs"], SHAPE["doc_len"], SHAPE["v"], SHAPE["k"]
    assert a["bytes_moved"](d, L, k, v) / H100["hbm_bytes_per_s"] == pytest.approx(0.2712e-3, rel=1e-3)
    assert a["flops"](d, L, k, v) / H100["tf32_flops"] < 0.05 * a["bytes_moved"](d, L, k, v) / H100["hbm_bytes_per_s"]
    assert c["bytes_moved"](d, k) / H100["hbm_bytes_per_s"] == pytest.approx(0.0382e-3, rel=1e-3)
    assert m["bytes_per_sweep"](d, L, k, v) / H100["hbm_bytes_per_s"] == pytest.approx(0.3862e-3, rel=1e-3)


def _ctx(**kw):
    from types import SimpleNamespace

    base = dict(ranges={}, busy_s=0.0, window_s=0.0, work=0, steps=0, shape=dict(SHAPE), peaks=H100,
                device_name="x")
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_share_and_silence():
    a = _module("hdp_assign_roofline")
    read = run.metric_reader("hdp_assign_roofline")
    bound = a["bytes_moved"](1_000_000, 50, 32, 10_000) / 3.35e12
    ctx = _ctx(ranges={"hdp_assign": {"device_s": 4 * 0.085, "launches": 40, "calls": 4}})
    assert read(ctx) == pytest.approx(100 * bound / 0.085)
    assert read(_ctx()) is None and read(_ctx(ranges=ctx.ranges, peaks=None)) is None
    crt = run.metric_reader("crt_roofline")
    assert crt(_ctx(ranges={"crt": {"device_s": 0.018, "launches": 200, "calls": 1}})) == pytest.approx(
        100 * 0.128000128e9 / 3.35e12 / 0.018)
    assert crt(_ctx(ranges={"crt": {"device_s": 0.0, "launches": 0, "calls": 0}})) is None
    mfu = run.metric_reader("hdp_mfu")
    per = _module("hdp_mfu")["bytes_per_sweep"](1_000_000, 50, 32, 10_000)
    assert mfu(_ctx(work=4, window_s=0.5)) == pytest.approx(100 * 4 * per / 0.5 / 3.35e12)
    assert mfu(_ctx(work=0, window_s=0.5)) is None


def test_crt_batches_per_sweep_on_a_hand_worked_record(monkeypatch):
    rec = {"window_s": 1.0, "counters": {"hdp.crt_batches": 200, "hdp.doc_chunks": 200},
           "spans": {"hdp.sweep": {"calls": 4, "host_s": 0.4, "self_s": 0.0}}, "reads": {}, "block_reads": {}}
    monkeypatch.setattr(program_record, "record", lambda: rec)
    assert run.metric_reader("crt_batches_per_sweep")(None) == 50
    for silent in (None, {**rec, "counters": {}}, {**rec, "spans": {}}):
        monkeypatch.setattr(program_record, "record", lambda silent=silent: silent)
        assert run.metric_reader("crt_batches_per_sweep")(None) is None


def test_the_record_of_the_tiny_cell(monkeypatch):
    """The child's work in this process: a chunk of dense sweeps recorded, one
    CRT batch a token of the longest document a sweep, two reads a step (the
    traces' copy and the saturation test: the CRT's cap is static)."""
    spec = tiny_spec()
    out = program_record.measure(spec, SEED, CPU)
    sweeps = spec.workload["chunk"]
    assert out["spans"]["hdp.sweep"]["calls"] == out["spans"]["hdp.crt"]["calls"] == sweeps
    assert out["spans"]["runner.assign_blocked_dense"]["calls"] == sweeps
    assert out["counters"]["hdp.doc_chunks"] == sweeps * TINY["n_docs"] // 1000
    assert out["reads"] == {"runner.trace": 1, "runner.saturated": 1}  # the CRT's cap static
    monkeypatch.setattr(program_record, "record", lambda: out)
    assert run.metric_reader("crt_batches_per_sweep")(None) == TINY["doc_len"]


def test_the_trace_ranges_of_the_tiny_cell():
    """A traced step opens the cell's ranges once a sweep; the CPU run has no
    device time, so the rooflines are silent there."""
    out = run.run_cell(tiny_spec(), SEED, 0.2, True, CPU)
    ranges = out["trace"].ranges
    sweeps = run.cell_spec(CELL).workload["chunk"]
    assert ranges["sweep"]["calls"] == ranges["hdp_assign"]["calls"] == ranges["crt"]["calls"] == sweeps
    assert "hdp_assign_roofline" not in out["metrics"] and "crt_roofline" not in out["metrics"]
    assert out["correct"], out["checks"]


@pytest.mark.cuda
def test_control_is_not_correct_at_the_cells_size(card):
    """On the card at the cell's own size, two seeds: the program is correct
    and the control is not, in the same runs."""
    spec = run.cell_spec(CELL)
    for seed in (2**31 + 11, 2**31 + 12):
        out = run.run_cell(spec, seed, 3.0, False, card, ("program", "control"))
        assert out["correct"], out["checks"]
        ok, checks = run.judge(out["readings"]["control"], spec.workload["limits"])
        assert not ok, checks
        assert math.isfinite(out["readings"]["program"]["assign_fit_t"])
        torch.cuda.empty_cache()


def test_the_reference_imports_nothing_of_the_program():
    from benchmark.tests.test_benchmark_imports import FORBIDDEN, _imported

    names = _imported("import benchmark.reference.hdp")
    assert not names & (FORBIDDEN | {"common_tpu_torch"}), names
