"""The port's bench (`common_tpu_torch/bench.py`) against the root `bench.py`
and the JAX package, on the CPU.

- `_capped_ess`, `_compact_summary` and `_ordered_for_tail` against
  `bench.py`'s on the same inputs;
- every tier at a tiny shape on the CPU returns its `bench.py` counterpart's
  keys (read from `bench.py`'s source, and from running `bench.py`'s tier on
  JAX's CPU where that takes seconds), with the renamings the port states;
- the default schedule at tiny shapes fills every key of the last line;
- held-out quality of the main path and config 2 against the JAX package's
  samplers on the same numpy rows, over several seeds;
- `python -m common_tpu_torch.bench` in a fresh process: no JAX, a last
  line that parses; without a card and without `--device cpu`, a non-zero
  exit; a tier that raises fails the run.
"""

import ast
import contextlib
import functools
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
from common_tpu import models as jmodels
from common_tpu import scalar_functions as jsf
from common_tpu import state as jst
from common_tpu.kernels import blocked as jblocked
from common_tpu.kernels import slice_ as jslice
from common_tpu_torch import bench as pb
from common_tpu_torch import models
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked, slice_

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the pieces copied from bench.py
# ---------------------------------------------------------------------------
def _ar1(seed, t, phi, scale=1.0, offset=0.0):
    r = np.random.default_rng(seed)
    x, e = np.zeros(t), r.normal(size=t)
    for i in range(1, t):
        x[i] = phi * x[i - 1] + e[i]
    return offset + scale * x


# traces of the ESS tier's length (300 sweeps), from independent draws to a
# slow chain, on the scale and offset of a score_joint trace
ESS_TRACES = {
    "independent_300": _ar1(0, 300, 0.0),
    "ar0.5_300": _ar1(1, 300, 0.5),
    "ar0.9_300": _ar1(2, 300, 0.9, 1e4, -3.7e8),
    "ar0.99_300": _ar1(3, 300, 0.99, 50.0, -2.1e6),
    "ar0.7_300": _ar1(4, 300, 0.7),
    "burn_in_300": np.concatenate([np.linspace(-4e8, -3.7e8, 30), _ar1(5, 270, 0.8, 1e3, -3.7e8)]),
    "k_active_steps": np.repeat([12.0, 13.0, 12.0, 14.0, 13.0, 13.0], 50),
    "short_19": _ar1(6, 19, 0.3),
    "flat": np.full(300, -1234.5),
    "nan_after_burn_in": np.concatenate([_ar1(7, 200, 0.5), [np.nan], _ar1(8, 99, 0.5)]),
}


@pytest.mark.parametrize("name", sorted(ESS_TRACES))
def test_capped_ess_matches_bench(name):
    """Equal to bench._capped_ess within 1e-6 relative (both estimate in
    float32, through different FFTs), None where it is None (a trace shorter
    than 20). A NaN after the burn-in ends Geyer's sequence at its first pair
    in both, so both read the cap."""
    trace = ESS_TRACES[name]
    want, got = bench._capped_ess(trace, len(trace)), pb._capped_ess(trace, len(trace))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-6)
    if name == "short_19":
        assert got is None
    if name == "nan_after_burn_in":
        assert got == want == 240.0


def _full_result(mfu_keys):
    """A result dict with every key the two benches put on the last line."""
    tier = {"n": 1000, "d": 8, "k_max": 16, "kernel": "fused", "sweeps": 5, "sweeps_per_s": 3.5}
    return {
        "metric": "fused Gibbs sweeps/s, 1000x8 DPMM-NIW K_max=16", "value": 3.5, "unit": "sweeps/s",
        "vs_baseline": 12.5, "device": "card", "fused_tier": tier,
        "ess_tier": {**tier, "n_seeds": 2, "ess_per_s": 0.1, "ess_per_s_spread": 0.02},
        "hdp": {"tokens_per_s": 4e8, "predictive": {"perplexity": 2700.0}},
        "smc": {"n": 1000, "d": 8, "particles": 4, "rows_per_s": 9e3, "logz": -1e4,
                "logz_health": {"logz_degenerate": False}, "predictive": {"per_dim": -1.4}},
        "configs": {"config2": {"sweeps_per_s": 1.0, "fused": {"sweeps_per_s": 1.2},
                                "predictive": {"mean_logp": -25.8}},
                    "config3": {"sweeps_per_s": 2.0, "predictive": {"mean_logp": -29.1}}},
        "chains_headline": {"chains": {"4": {"aggregate_chain_sweeps_per_s": 6.0}}, "vs_single_chain": 0.8},
        "tiers": [tier], "ess_tier_sm": {"ess_per_s": 1.0, "ess_per_s_spread": 0.5, "ab_plain_ess_per_s": 0.9},
        "efficiency": {"chains_on_chip": {"efficiency": 0.6}},
        "predictive": {"heldout_rows": 4096, "mean_logp": -369.6, "per_dim": -1.44},
        "ess_per_s": 0.1, "ess_per_s_spread": 0.02, "ess_est": 3.5, "k_active": 8, "tflops": 60.0,
        **mfu_keys,
        "baseline": "numpy", "baseline_sweeps_per_s": 1e-5, "baseline_range": [1e-5, 2e-5],
        "partial": False, "total_s": 600.0,
    }


def test_summary_and_tail_order_match_bench():
    """One result: bench.py's summary, and its key order with the headline
    last, apart from `mfu_vs_bf16_peak`, which the port reports as `mfu` and
    `peak_tflops`."""
    want = bench._ordered_for_tail(_full_result({"mfu_vs_bf16_peak": 0.3}))
    got = pb._ordered_for_tail(_full_result({"mfu": 0.12, "peak_tflops": 495.0}))
    assert got["summary"] == want["summary"]
    renamed = []
    for k in want:
        renamed += ["mfu", "peak_tflops"] if k == "mfu_vs_bf16_peak" else [k]
    assert list(got) == renamed
    assert list(got)[-3:] == ["unit", "value", "metric"]


# ---------------------------------------------------------------------------
# tier keys
# ---------------------------------------------------------------------------
def _bench_function(func):
    tree = ast.parse((REPO / "bench.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)


def _bench_keys(func):
    """The keys of the dict `bench.py`'s `func` returns, read from its source:
    a returned dict literal, or the dict assigned to the returned name plus
    the keys set on it by subscript."""
    fn = _bench_function(func)
    ret = fn.body[-1].value
    if isinstance(ret, ast.Dict):
        return {k.value for k in ret.keys}
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == ret.id and isinstance(node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys}
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) and t.value.id == ret.id
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    return keys


# what the port reports otherwise: no ahead-of-time compile (a warm-up run's
# seconds where bench.py timed its compile), no stalled-seed marking (every
# seed counts), `mfu` against the H100's TF32 peak, and each tier's launches of
# the four kernels
RENAMED = {"compile_s": "warmup_s", "mfu_vs_bf16_peak": ("mfu", "peak_tflops")}
DROPPED = {"run_ess_tier": {"compile_s", "stalled_seeds", "seeds_truncated"}, "run_smc_tier": {"compile_s"}}


def _port_keys(func):
    keys = set()
    for k in _bench_keys(func) - DROPPED.get(func, set()):
        v = RENAMED.get(k, k)
        keys |= set(v) if isinstance(v, tuple) else {v}
    return keys | {"launches"}


CPU = "cpu"
TINY = {
    "run_tier": lambda: pb.run_tier(600, 4, 8, 4, 0, device=CPU),
    "run_ess_tier": lambda: pb.run_ess_tier(600, 4, 8, 0, sweeps=25, n_seeds=2, heldout=32, device=CPU),
    "run_chain_scaling_tier": lambda: pb.run_chain_scaling_tier(0, n=256, d=4, k_max=4, sweeps=2,
                                                                chain_counts=(1, 2), repeats=1, device=CPU),
    "run_chains_headline_tier": lambda: pb.run_chains_headline_tier(0, 256, 6, 4, chain_counts=(2,), sweeps=2,
                                                                    repeats=1, device=CPU),
    "run_config2_tier": lambda: pb.run_config2_tier(0, n=300, d=6, k_max=6, sweeps=2, heldout=32, device=CPU),
    "run_config3_tier": lambda: pb.run_config3_tier(0, n=200, k_max=6, sweeps=1, heldout=16, device=CPU),
    "run_hdp_tier": lambda: pb.run_hdp_tier(120, 8, 5, 40, 2, 0, doc_chunk=50, heldout_frac=0.1, device=CPU),
    "run_smc_tier": lambda: pb.run_smc_tier(300, 3, 6, 3, 0, block=64, warmup=16, heldout=16, device=CPU),
}


@pytest.mark.parametrize("func", sorted(TINY))
def test_tier_keys_match_bench(func):
    """Each tier at a tiny shape on the CPU returns its bench.py counterpart's
    keys (as its source writes them) with the port's stated differences; no
    kernel launches on the CPU."""
    out = TINY[func]()
    assert set(out) == _port_keys(func)
    assert out["launches"] == {"gaussian_assign": 0, "gaussian_assign_chains": 0, "linear_assign": 0,
                               "scatter_stats": 0, "hdp_assign": 0}


def _bench_dicts(func):
    """The dict literals of bench.py's `func`, by the name they are assigned to
    or appended to (`name[...] = {...}`, `name.append({...})`)."""
    out = {}
    for node in ast.walk(_bench_function(func)):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            t = node.targets[0]
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                out[t.value.id] = {k.value for k in node.value.keys}
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "append"
                and node.args and isinstance(node.args[0], ast.Dict)):
            out[node.func.value.id] = {k.value for k in node.args[0].keys}
    return out


def test_tier_keys_match_bench_nested():
    """bench.py's ladder tier, run on JAX's CPU at a tiny shape, returns the
    keys read from its source; the nested records read from its source (an
    ESS seed's, the chains' per-C record) match the port's: the port scores
    each seed's held-out rows (bench.py only the last seed's, as `predictive`)
    and times a warm-up run for `compile_s`."""
    tier = bench.run_tier(600, 4, 8, 4, jax.random.key(0))
    assert set(tier) == _bench_keys("run_tier")
    port_ess = TINY["run_ess_tier"]()
    assert set(port_ess["seeds"][0]) == _bench_dicts("run_ess_tier")["seeds_out"] | {"heldout_per_dim"}
    assert port_ess["predictive"]["per_dim"] == port_ess["seeds"][-1]["heldout_per_dim"]
    assert set(port_ess["predictive"]) == {"heldout_rows", "mean_logp", "per_dim"}
    port_chains = TINY["run_chains_headline_tier"]()
    assert set(port_chains["chains"]["2"]) == {RENAMED.get(k, k)
                                               for k in _bench_dicts("run_chains_headline_tier")["out_by_c"]}


@pytest.fixture
def tiny_schedule(monkeypatch):
    """The default schedule's constants and tier shapes cut to a few hundred rows."""
    monkeypatch.setattr(pb, "LADDER", [(400, 4, 6, 3), (600, 6, 8, 3)])
    monkeypatch.setattr(pb, "ESS_TIER", (500, 4, 6, 200))
    monkeypatch.setattr(pb, "ESS_SWEEPS", 25)
    monkeypatch.setattr(pb, "ESS_SEEDS", 2)
    monkeypatch.setattr(pb, "ESS_HELDOUT", 32)
    monkeypatch.setattr(pb, "SM_SWEEPS", 20)
    monkeypatch.setattr(pb, "HDP_TIER", (100, 8, 5, 40, 2))
    monkeypatch.setattr(pb, "SMC_TIER", (300, 3, 6, 3, 64, 16))
    for name, kw in (("run_chain_scaling_tier", dict(n=256, d=4, k_max=4, sweeps=2, repeats=1)),
                     ("run_config2_tier", dict(n=300, d=6, k_max=6, sweeps=2, heldout=32)),
                     ("run_config3_tier", dict(n=200, k_max=6, sweeps=1, heldout=16)),
                     ("run_hdp_tier", dict(doc_chunk=50, heldout_frac=0.1)),
                     ("numpy_collapsed_rows_per_s", dict(budget_s=0.05, replicates=1))):
        monkeypatch.setattr(pb, name, functools.partial(getattr(pb, name), **kw))


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pb.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_default_schedule_fills_every_key(tiny_schedule):
    """Every tier of the default schedule, at tiny shapes on the CPU: the last
    line carries bench.py's headline keys (with `mfu` and `peak_tflops`) and
    a summary of every tier, headline last."""
    rc, line = _main(["--device", "cpu", "--seed", "3"])
    assert rc == 0 and line["partial"] is False
    assert set(line["summary"]) == {"fused", "predictive", "ess", "hdp", "smc", "config2", "config3",
                                    "chains_headline", "ess_sm", "efficiency"}
    for k in ("metric", "value", "unit", "ess_per_s", "ess_per_s_spread", "k_active", "tflops", "mfu",
              "peak_tflops", "baseline_sweeps_per_s", "vs_baseline", "device"):
        assert line[k] is not None, k
    assert list(line)[-3:] == ["unit", "value", "metric"]
    assert "mfu_vs_bf16_peak" not in line and line["peak_tflops"] == 495.0
    assert [t["n"] for t in line["tiers"][:2]] == [400, 600] and line["fused_tier"]["kernel"] == "fused"
    assert line["configs"]["config2"]["fused"]["sweeps_per_s"] > 0
    assert line["ess_tier_sm"]["kernel"] == "fused+sm" and line["ess_tier_sm"]["ab_plain_ess_per_s"] is not None


@pytest.mark.parametrize("tier", ["chains", "config3"])
def test_one_tier_alone(tiny_schedule, tier):
    """--tier runs that tier and no other."""
    rc, line = _main(["--device", "cpu", "--tier", tier])
    assert rc == 0
    filled = {"chains": "efficiency", "config3": "configs"}[tier]
    assert line[filled]
    assert line["tiers"] == [] and line["value"] is None and line["fused_tier"] is None


def test_a_tier_that_raises_fails_the_run(tiny_schedule, monkeypatch):
    """The run stops at the first tier that raises: what completed is printed
    with partial true, and the exit code is 1; no later tier runs."""
    ran = []

    def boom(*a, **kw):
        raise RuntimeError("tier failed")

    monkeypatch.setattr(pb, "run_ess_tier", boom)
    monkeypatch.setattr(pb, "run_hdp_tier", lambda *a, **kw: ran.append("hdp"))
    rc, line = _main(["--device", "cpu"])
    assert rc == 1 and line["partial"] is True
    assert line["value"] is not None and line["fused_tier"] is not None
    assert line["ess_tier"] is None and not ran


# ---------------------------------------------------------------------------
# quality against the JAX package on the same rows
# ---------------------------------------------------------------------------
# The held-out density after a short chain depends on the seed's data and on
# which planted clusters the chain has merged, so both packages run the same
# numpy rows a seed and the test bounds the mean of the paired differences.
# Pilot (seeds 0-15 at these shapes, on the CPU): the main path's difference
# in per_dim has sd 0.099 a seed (mean -0.047), config 2's in mean_logp sd
# 0.162 (mean -0.035); the bar is 4 standard errors of the mean over the seeds
# run.
MAIN_SEEDS, MAIN_SD = 4, 0.099
CONFIG2_SEEDS, CONFIG2_SD = 4, 0.162


def test_main_path_quality_matches_jax():
    """4000 x 8, K=16, 40 sweeps from a CRP start: the port's fused sweep (on
    the CPU its kernels' plain versions) and the JAX package's blocked sweep
    (bench.py's own `build_tier_fn` program) on the same rows and hypers."""
    n, d, k, sweeps, heldout = 4000, 8, 16, 40, 1024
    _, run = bench.build_tier_fn(n, d, k, sweeps, "blocked", 0)
    defn = jst.model_definition(n, [jmodels.niw(d)], k_max=k)
    hyper = {"mu0": jnp.zeros(d), "kappa": 1.0, "psi": jnp.eye(d), "nu": float(d + 2)}
    held_lp = jax.jit(lambda s, xh: jnp.mean(jst.heldout_logp(s, ((xh, jnp.ones(xh.shape[0])),))))
    diffs = []
    for seed in range(MAIN_SEEDS):
        rows = pb.mixture_rows(pb._rows_rng(seed, 17, 0), n + heldout, d)
        x, xh = jnp.asarray(rows[:n]), jnp.asarray(rows[n:])
        s = jst.initialize(defn, ((x, jnp.ones(n)),), jax.random.key(seed), cluster_hp={"alpha": 1.0},
                           feature_hps=[hyper])
        s, _ = run(x, s, jax.random.key(1000 + seed))
        want = float(held_lp(s, xh)) / d
        got = pb.run_tier(n, d, k, sweeps, seed, kernel="fused", heldout=heldout, device=CPU)
        assert got["predictive"]["heldout_rows"] == heldout
        diffs.append(got["predictive"]["per_dim"] - want)
    bar = 4 * MAIN_SD / np.sqrt(MAIN_SEEDS)
    assert abs(np.mean(diffs)) <= bar, (diffs, bar)


def test_config2_quality_matches_jax():
    """Config 2 at 1000 x 8 binary, K=16, 8 iterations of a blocked sweep and
    the slice-sampled hypers at the tier's settings (`config2_hp_specs`,
    bench.py:800-807) on the same rows: the port's plain chain, the one the
    tier's `predictive` scores, against the JAX package's sweep and
    `slice_._hp_impl`."""
    n, d, k, iters, heldout = 1000, 8, 16, 8, 1024
    beta_hp = {"prior": jsf.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)}
    specs = {0: {"alpha": beta_hp, "beta": beta_hp}}
    cluster = {"prior": jsf.log_exponential(1.0), "w": 0.5, "bounds": (1e-4, 1e4)}
    defn = jst.model_definition(n, [jmodels.bbv(d)], k_max=k)
    tdefn = st.model_definition(n, [models.bbv(d)], k_max=k)
    hp_kw = pb.config2_hp_specs()

    @jax.jit
    def run(s, x, key):
        data = ((x, jnp.ones(n)),)

        def body(s, t):
            kt = jax.random.fold_in(key, t)
            s = jblocked.sweep(s, data, jax.random.fold_in(kt, 0))
            s = jslice._hp_impl(s, jax.random.fold_in(kt, 1), specs=specs, cluster=cluster)
            return s, jst.score_joint(s)

        return jax.lax.scan(body, s, jnp.arange(iters))

    diffs = []
    for seed in range(CONFIG2_SEEDS):
        rows = pb.binary_rows(pb._rows_rng(seed, 21, 0), n + heldout, d)
        x, xh = jnp.asarray(rows[:n]), jnp.asarray(rows[n:])
        s = jst.initialize(defn, ((x, jnp.ones(n)),), jax.random.key(seed), cluster_hp={"alpha": 1.0},
                           feature_hps=[{"alpha": jnp.ones(d), "beta": jnp.ones(d)}])
        s, _ = run(s, x, jax.random.key(1000 + seed))
        want = float(jnp.mean(jst.heldout_logp(s, ((xh, jnp.ones(heldout)),))))
        data, held = pb._columns(rows[:n], CPU), pb._columns(rows[n:], CPU)
        gen = pb._generator(torch.device(CPU), seed, 21, 2)
        ts = st.initialize(tdefn, data, pb._generator(torch.device(CPU), seed, 21, 1), cluster_hp={"alpha": 1.0},
                           feature_hps=[{"alpha": np.ones(d, np.float32), "beta": np.ones(d, np.float32)}])
        for _ in range(iters):
            ts = slice_.hp(blocked.sweep(ts, data, gen), data, gen, **hp_kw)
        diffs.append(float(st.heldout_logp(ts, held).mean()) - want)
    bar = 4 * CONFIG2_SD / np.sqrt(CONFIG2_SEEDS)
    assert abs(np.mean(diffs)) <= bar, (diffs, bar)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------
def test_cpu_smoke_in_a_fresh_process_loads_no_jax():
    """`python -m common_tpu_torch.bench --device cpu --smoke`: exit 0, a last
    line with `metric` and `value`, and no module of JAX or of the JAX package
    imported (`-X importtime` lists every import)."""
    out = subprocess.run([sys.executable, "-X", "importtime", "-m", "common_tpu_torch.bench", "--device", "cpu",
                          "--smoke"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in out.stderr.splitlines() if ln.startswith("import time:")]
    assert "common_tpu_torch.kernels.blocked" in imported
    bad = [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "common_tpu") or m == "bench"]
    assert not bad, bad
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"].endswith("Gibbs sweeps/s, 20000x16 DPMM-NIW K_max=16") and line["value"] > 0
    assert line["device"] == "cpu" and line["summary"]["fused"]["sweeps_per_s"] > 0


def test_without_a_card_the_bench_exits_nonzero():
    """No `--device cpu` and no card: the run stops before any tier."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run on it")
    out = subprocess.run([sys.executable, "-m", "common_tpu_torch.bench", "--smoke"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and not out.stdout.strip()
