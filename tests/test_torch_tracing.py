"""The port's own spans, host reads and counters (`utils/profiling.py`), on the CPU.

Off by default: the samplers build no span and give the same draws bit for
bit with the recorder on. On: spans nest inside their parents, the reads
count the samplers' loop tests and ESS checks exactly, and under a
`torch.profiler` every span is a `record_function` range nested as the
recorder has it.
"""

import dataclasses
import math
from collections import Counter

import numpy as np
import pytest
import torch

from common_tpu_torch import models, rng
from common_tpu_torch import scalar_functions as sf
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked, hmc, slice_, smc
from common_tpu_torch.runner import runner
from common_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _gen(seed):
    return rng(seed, "cpu").generator


def _leaves(obj):
    """Every tensor of a state, a result tuple or a dict, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, dict):
        obj = [obj[k] for k in sorted(obj)]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _leaves(o)]
    return []


def _slice_hp_run():
    r = np.random.default_rng(0)
    n, d = 200, 4
    z = r.integers(0, 3, n)
    X = (r.random((n, d)) < np.array([[0.1, 0.9, 0.5, 0.2], [0.9, 0.1, 0.5, 0.8], [0.5, 0.5, 0.1, 0.9]])[z])
    data = ((torch.from_numpy(X.astype(np.float32)), torch.ones(n)),)
    defn = st.model_definition(n, [models.bbv(d)], k_max=8)
    s = st.initialize(defn, data, _gen(0), cluster_hp={"alpha": 1.0})
    spec = {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)}
    config = [("assign_blocked_fused", {}),
              ("slice_hp", {"specs": {0: {"alpha": spec, "beta": spec}},
                            "cluster": {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (1e-4, 1e4)}})]
    run = runner(defn, data, s, config)
    run.run(_gen(1), 2)
    return [run.get_latent(), run.score_trace, run.assignment_trace]


def _niw_rows(n, d, seed):
    r = np.random.default_rng(seed)
    centers = r.normal(scale=4.0, size=(3, d))
    x = centers[r.integers(0, 3, n)] + r.normal(size=(n, d))
    return ((torch.from_numpy(x.astype(np.float32)), torch.ones(n)),)


def _sweep_fused_run():
    data = _niw_rows(300, 3, 1)
    defn = st.model_definition(300, [models.niw(3)], k_max=5)
    s = st.initialize(defn, data, _gen(2), cluster_hp={"alpha": 1.0})
    gen = _gen(3)
    for _ in range(2):
        s = blocked.sweep_fused(s, data, gen)
    return s


N_SMC, BLOCK, WARMUP = 100, 16, 8
N_BLOCKS = math.ceil((N_SMC - WARMUP) / BLOCK)


def _run_blocked_run():
    data = _niw_rows(N_SMC, 2, 4)
    defn = st.model_definition(N_SMC, [models.niw(2)], k_max=4)
    parts = smc.init_particles(defn, data, _gen(5), 4, cluster_hp={"alpha": 1.0})
    return smc.run_blocked(parts, data, _gen(6), block=BLOCK, warmup=WARMUP)


HDP_D, HDP_L, HDP_CHUNK, HDP_STEPS = 40, 10, 16, 2


def _hdp_start():
    from common_tpu_torch import topic

    g = torch.Generator().manual_seed(7)
    words = torch.randint(0, 30, (HDP_D, HDP_L), generator=g)
    mask = (torch.rand((HDP_D, HDP_L), generator=g) > 0.1).float()
    data = topic.dense_token_data(words, mask)
    return data, topic.initialize(data, 5, 30, _gen(8), n_docs=HDP_D)


def _hdp_dense_run():
    data, s = _hdp_start()
    run = runner(None, data, s, [("assign_blocked_dense", {"doc_chunk": HDP_CHUNK}), ("beta", {})])
    run.run(_gen(9), HDP_STEPS)
    return [run.get_latent(), run.score_trace, run.assignment_trace]


IRM_N, IRM_K, IRM_STEPS, IRM_CHUNK, IRM_STATS = (30, 24), 4, 2, 100, 256


def _irm_start():
    """A bipartite bb relation (domain 0 x domain 1) and a self-relation on
    domain 1: domain 0's blocked step builds a table, domain 1's runs the
    sequential loop."""
    from common_tpu_torch import relational as irm
    from common_tpu_torch.data import sparse_ndarray_dataview

    r = np.random.default_rng(3)
    n0, n1 = IRM_N
    rels = [r.random((n0, n1)) < 0.3, r.random((n1, n1)) < 0.5]
    views = irm.as_views([sparse_ndarray_dataview(dense=x.astype(np.float32), device="cpu") for x in rels])
    defn = irm.model_definition([n0, n1], [((0, 1), models.bb), ((1, 1), models.bb)], k_max=IRM_K)
    return views, irm.initialize(defn, views, _gen(12), cluster_hps=[{"alpha": 1.0}] * 2)


def _irm_run():
    """Runner steps of [assign_blocked, assign over domain 0], with a table
    chunk of IRM_CHUNK cells and a restat chunk of IRM_STATS cells."""
    from common_tpu_torch.relational import kernels
    from common_tpu_torch.relational import state as irm_state

    saved = kernels.TABLE_ELEMS, irm_state.STATS_CELLS
    kernels.TABLE_ELEMS, irm_state.STATS_CELLS = IRM_CHUNK * IRM_K, IRM_STATS
    try:
        views, s = _irm_start()
        run = runner(None, views, s, [("assign_blocked", {}), ("assign", {"domain": 0})])
        run.run(_gen(13), IRM_STEPS)
    finally:
        kernels.TABLE_ELEMS, irm_state.STATS_CELLS = saved
    return [run.get_latent(), run.score_trace, run.assignment_trace]


RUNS = {"slice_hp": _slice_hp_run, "sweep_fused": _sweep_fused_run, "run_blocked": _run_blocked_run,
        "hdp_dense": _hdp_dense_run, "irm": _irm_run}


@pytest.fixture(scope="module")
def recorded():
    """Each path run once with the recorder off (no span object built) and
    once on, from the same seeds: (off result, on result, record)."""
    out = {}
    built = []
    real = profiling._Span.__init__

    def counting(self, *args):
        built.append(args[1])
        real(self, *args)

    for name, fn in RUNS.items():
        profiling._Span.__init__ = counting
        try:
            off = fn()
        finally:
            profiling._Span.__init__ = real
        assert built == [] and profiling._RECORD is None, (name, built[:5])
        with profiling.recording() as rec:
            on = fn()
        assert profiling._RECORD is None
        out[name] = (off, on, rec)
    return out


@pytest.mark.parametrize("path", sorted(RUNS))
def test_recorder_off_by_default_and_on_gives_the_same_draws(recorded, path):
    off, on, rec = recorded[path]
    a, b = _leaves(off), _leaves(on)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    assert rec.spans and not rec.profiled and rec.end_ns > rec.start_ns


@pytest.mark.parametrize("path", sorted(RUNS))
def test_spans_nest_inside_their_parents(recorded, path):
    rec = recorded[path][2]
    for name, start, end, parent in rec.spans:
        assert end >= start > 0, name
        assert rec.start_ns <= start and end <= rec.end_ns
        if parent >= 0:
            _, p_start, p_end, _ = rec.spans[parent]
            assert p_start <= start and end <= p_end, (name, rec.spans[parent][0])
    summary = rec.summary()
    assert all(s["self_s"] >= 0 and s["self_s"] <= s["host_s"] for s in summary.values())
    assert not rec.open


def test_the_runner_and_slice_spans(recorded):
    rec = recorded["slice_hp"][2]
    s = rec.summary()
    assert s["runner.step"]["calls"] == 2
    assert s["runner.assign_blocked_fused"]["calls"] == s["runner.slice_hp"]["calls"] == 2
    assert s["sweep.inputs"]["calls"] == s["sweep.assign"]["calls"] == s["sweep.restat"]["calls"] == 2
    updates = 2 * (4 + 4 + 1)  # alpha and beta, coordinate by coordinate, then the concentration
    assert s["slice.update"]["calls"] == updates
    # bbv's Beta hypers and the concentration under Exp priors: every update
    # is one `slice_update` (on the card one launch, no read), with no loop span
    assert rec.counters["slice.fused_updates"] == updates
    assert "slice.step_out" not in s and "slice.shrink" not in s
    reads = rec.reads()
    assert reads["runner.trace"] == 1 and reads["runner.saturated"] == 1
    assert set(reads) == {"runner.trace", "runner.saturated", "slice.step_out", "slice.shrink"}
    # on the CPU its plain version tests on the host, as the loop does: each
    # side's first step-out test and at least one proposal, a target
    # evaluation before each test, plus the level's
    assert reads["slice.step_out"] >= 2 * updates and reads["slice.shrink"] >= updates
    assert rec.counters["slice.evals"] == updates + reads["slice.step_out"] + reads["slice.shrink"]
    assert s["runner.step"]["host_s"] >= s["runner.slice_hp"]["host_s"] >= s["slice.update"]["host_s"]


def test_hdp_dense_spans_and_counters(recorded):
    """Runner steps of the dense HDP route: the sweep and its stages, the
    CRT and beta's draw, a chunk of docs and a Bernoulli batch counted each.
    The start's beta draw (in `initialize`, given no CRT cap) reads the
    largest doc-topic count once; the runner's steps, with their static
    cap, read nothing but the traces and the saturation test."""
    rec = recorded["hdp_dense"][2]
    s = rec.summary()
    n = HDP_STEPS
    assert {k: v["calls"] for k, v in s.items()} == {
        "runner.step": n, "runner.assign_blocked_dense": n, "runner.beta": n, "hdp.sweep": n, "hdp.draw": n,
        "hdp.assign": n, "hdp.topic_word": n, "hdp.crt": n + 1, "hdp.beta": n + 1,
        "read.hdp.max_count": 1, "read.runner.trace": 1, "read.runner.saturated": 1}
    first_cap = int(_hdp_start()[1].doc_topic.max())  # initialize's sample_beta, before the steps
    assert rec.counters == {"hdp.doc_chunks": n * math.ceil(HDP_D / HDP_CHUNK),
                            "hdp.crt_batches": first_cap + n * HDP_L}
    parents = Counter((r[0], rec.spans[r[3]][0] if r[3] >= 0 else None) for r in rec.spans)
    assert parents[("hdp.sweep", "runner.assign_blocked_dense")] == parents[("hdp.crt", "runner.beta")] == n
    assert parents[("hdp.draw", "hdp.sweep")] == parents[("hdp.assign", "hdp.sweep")] == n
    assert parents[("hdp.topic_word", "hdp.sweep")] == parents[("hdp.beta", "runner.beta")] == n
    assert rec.reads(within="runner.step") == {}
    assert rec.reads() == {"hdp.max_count": 1, "runner.trace": 1, "runner.saturated": 1}


def test_irm_spans_and_counters(recorded):
    """Runner steps of the IRM: the blocked sweep and its stages (a table and
    an assignment for the bipartite domain, the sequential loop for the
    self-relational one), the collapsed step, a chunk of the table's cells and
    of each relation's restat counted each (the start's restat too); no read
    inside a step."""
    rec = recorded["irm"][2]
    s = rec.summary()
    n = IRM_STEPS
    assert {k: v["calls"] for k, v in s.items()} == {
        "runner.step": n, "runner.assign_blocked": n, "runner.assign": n, "irm.sweep": n, "irm.theta": n,
        "irm.table": n, "irm.assign": n, "irm.sequential": n, "irm.restat": n, "irm.collapsed": n,
        "read.runner.trace": 1, "read.runner.saturated": 1}
    n0, n1 = IRM_N
    restat_chunks = math.ceil(n0 * n1 / IRM_STATS) + math.ceil(n1 * n1 / IRM_STATS)
    assert rec.counters == {"irm.table_chunks": n * math.ceil(n0 * n1 / IRM_CHUNK),
                            "irm.restat_chunks": (1 + n) * restat_chunks}
    parents = Counter((r[0], rec.spans[r[3]][0] if r[3] >= 0 else None) for r in rec.spans)
    assert parents[("irm.sweep", "runner.assign_blocked")] == parents[("irm.collapsed", "runner.assign")] == n
    for child in ("irm.theta", "irm.table", "irm.assign", "irm.sequential", "irm.restat"):
        assert parents[(child, "irm.sweep")] == n, child
    assert rec.reads(within="runner.step") == {}


def test_sweep_fused_spans(recorded):
    rec = recorded["sweep_fused"][2]
    s = rec.summary()
    assert {k: v["calls"] for k, v in s.items()} == {"sweep.inputs": 2, "sweep.assign": 2, "sweep.restat": 2}
    assert rec.reads() == {}


@pytest.mark.parametrize("x0", [torch.tensor(0.3), torch.tensor([0.3, -1.0, 2.0])])
def test_slice_reads_equal_the_loop_tests(x0):
    """A flat target always grows: each step-out runs to its cap of 16 steps,
    one test a step, and the first shrink lands (one test)."""
    with profiling.recording() as rec:
        for _ in range(3):
            x = slice_.slice_sample(_gen(7), x0, torch.zeros_like, w=0.5)
    assert x.shape == x0.shape
    cap = slice_._MAX_STEPOUT
    assert rec.reads() == {"slice.step_out": 3 * 2 * cap, "slice.shrink": 3}
    assert rec.counters == {"slice.evals": 3 * (1 + 2 * (1 + cap) + 1)}
    s = rec.summary()
    assert s["slice.update"]["calls"] == 3 and s["slice.step_out"]["calls"] == 6


@pytest.mark.parametrize("seed", range(4))
def test_slice_reads_count_the_shrinks(seed):
    """A target flat on [-1, 1] and -inf outside, from 0 with width 0.5: each
    step-out tests three times (two steps inside, the third lands outside),
    and the shrinkage tests once a proposal, each proposal one evaluation."""
    def logf(v):
        return torch.where(v.abs() <= 1.0, 0.0, -math.inf)

    with profiling.recording() as rec:
        x = slice_.slice_sample(_gen(20 + seed), torch.tensor(0.0), logf, w=0.5)
    assert abs(float(x)) <= 1.0
    reads = rec.reads()
    assert reads["slice.step_out"] == 6
    assert reads["slice.shrink"] == rec.counters["slice.evals"] - (1 + 2 * 3) >= 1


def test_smc_reads_one_ess_a_step_and_spans_each_step(recorded):
    rec = recorded["run_blocked"][2]
    s = rec.summary()
    assert s["smc.pass"]["calls"] == 1
    assert s["smc.warmup_step"]["calls"] == WARMUP and s["smc.block_step"]["calls"] == N_BLOCKS
    assert s["smc.seat"]["calls"] == s["smc.resample"]["calls"] == WARMUP + N_BLOCKS
    assert s["smc.rejuv"]["calls"] == N_BLOCKS  # every block step; no warm-up window (warmup < block)
    assert rec.reads() == {"smc.ess": WARMUP + N_BLOCKS, "rng.host_generator": 1}
    assert rec.reads(within="smc.block_step") == {"smc.ess": N_BLOCKS}
    assert rec.reads(within="smc.warmup_step") == {"smc.ess": WARMUP}


def test_nuts_reads_are_its_info_reads():
    q = torch.tensor([0.5, -0.2, 1.0], dtype=torch.float64)
    for step_size in (0.3, torch.tensor(0.3, dtype=torch.float64)):
        with profiling.recording() as rec:
            _, _, info = hmc.nuts_step(lambda v: -0.5 * (v * v).sum(), q, _gen(9), step_size, max_depth=6)
        reads = rec.reads()
        assert sum(reads.values()) == info.reads
        assert reads["hmc.directions"] == 1 and reads.get("hmc.step_size", 0) == (not isinstance(step_size, float))
        assert reads["hmc.leaf"] >= 1


def test_record_summary_and_reads_on_hand_worked_rows():
    rec = profiling.Record(profiled=False)
    rec.spans = [
        ["smc.block_step", 0, 100, -1],
        ["smc.seat", 10, 40, 0],
        ["read.smc.ess", 50, 60, 0],
        ["smc.rejuv", 60, 90, 0],
        ["read.x", 70, 75, 3],
        ["read.smc.ess", 200, 230, -1],
        ["smc.block_step", 300, 310, -1],
    ]
    s = rec.summary()
    assert s["smc.block_step"] == {"calls": 2, "host_s": pytest.approx(110e-9),
                                   "self_s": pytest.approx((100 - 30 - 10 - 30 + 10) * 1e-9)}
    assert s["smc.rejuv"]["self_s"] == pytest.approx(25e-9)
    assert s["read.smc.ess"] == {"calls": 2, "host_s": pytest.approx(40e-9), "self_s": pytest.approx(40e-9)}
    assert rec.reads() == {"smc.ess": 2, "x": 1}
    assert rec.reads(within="smc.block_step") == {"smc.ess": 1, "x": 1}
    assert rec.reads(within="smc.rejuv") == {"x": 1}


def test_off_calls_do_nothing_and_nested_recordings_restore():
    t = torch.tensor(2.5)
    assert profiling._RECORD is None
    assert profiling.read(t, "x") == 2.5 and profiling.count("c") is None
    with profiling.span("a") as inner:
        assert inner is None
    with profiling.recording() as outer:
        profiling.count("c", 2)
        with profiling.recording() as nested:
            profiling.count("c")
            with profiling.span("b"):
                profiling.read(t, "y")
        profiling.count("c")
    assert profiling._RECORD is None
    assert outer.counters == {"c": 3} and outer.spans == []
    assert nested.counters == {"c": 1} and [r[0] for r in nested.spans] == ["b", "read.y"]
    assert nested.spans[1][3] == 0  # the read's parent is the span b


def test_program_spans_are_profiler_ranges_nested_alike():
    """Under a CPU torch.profiler each span is a record_function event of its
    name, and the innermost enclosing program span of each event is the
    span's parent in the record."""
    from torch.profiler import ProfilerActivity, profile

    data = _niw_rows(60, 2, 8)
    defn = st.model_definition(60, [models.niw(2)], k_max=3)
    parts = smc.init_particles(defn, data, _gen(10), 2, cluster_hp={"alpha": 1.0})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            smc.run_blocked(parts, data, _gen(11), block=16, warmup=4)
    assert rec.profiled
    names = {r[0] for r in rec.spans}
    want = Counter((r[0], rec.spans[r[3]][0] if r[3] >= 0 else None) for r in rec.spans)
    got = Counter()
    for e in prof.events():
        if e.name not in names:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in names:
            p = p.cpu_parent
        got[(e.name, None if p is None else p.name)] += 1
    assert got == want
