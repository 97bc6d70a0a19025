"""The port's benchmark: `bench.py`'s measured tiers on one NVIDIA card.

    python -m common_tpu_torch.bench [--smoke] [--tier NAME] [--seed S]
                                     [--n N --d D --k K --sweeps S] [--device cpu]

Prints one JSON line last, under the root `bench.py`'s names: `metric`,
`value`, `unit`, `ess_per_s`, `ess_per_s_spread`, `k_active`, `tflops`,
`baseline_sweeps_per_s`, `vs_baseline`, `device` and a compact `summary` of
every tier, ordered so that the headline keys come last. One name differs:
`bench.py`'s `mfu_vs_bf16_peak` divides by a TPU figure, so the port reports
`mfu` against `peak_tflops`, the H100's dense TF32 tensor-core rate.

The tiers, in `bench.py`'s order (`--tier` runs one alone):

- `ladder`: blocked Gibbs (the plain sweep) at each shape of `LADDER`;
- `fused`: the fused sweep (kernels 1 and 2) at the top ladder shape;
- `ess`: ESS/s over `ESS_SEEDS` seeds of `ESS_SWEEPS` fused sweeps at the top
  shape, each seed with its own data and start, and the held-out density;
- `hdp`: config 4, HDP-LDA's dense sweep at 1M docs x 50 tokens;
- `chains`: path A's chain scaling on one card (kernel 4);
- `chains_headline`: C = 4 chains at the top shape (kernel 4);
- `config2`, `config3`, `smc` (config 5, kernel 2 on its rebuilds);
- `ess_sm`: the split-merge A/B, fused sweeps with and without moves;
- `baseline`: the reference architecture's per-row collapsed Gibbs in numpy.

`--smoke` runs the first ladder shape and the fused tier at that shape.
Data is made with numpy from `--seed`, so the JAX package can be fed the
same rows. Every tier runs on the card unless `--device cpu` names
the CPU; without a card the run stops. A tier that raises ends the run: the
line of what completed is printed with `partial` true and the exit code is 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from common_tpu_torch import models, scalar_functions
from common_tpu_torch import state as st
from common_tpu_torch import topic
from common_tpu_torch.kernels import blocked, hmc, slice_, smc, splitmerge
from common_tpu_torch.ops import _build, gaussian_assign, hdp_assign, linear_assign, suffstat
from common_tpu_torch.parallel import stack_states, unstack_state
from common_tpu_torch.utils import diagnostics

# (n, d, k_max, sweeps), smallest first; the last is the BASELINE.md headline (bench.py:1342-1348)
LADDER = [
    (20_000, 16, 16, 10),
    (100_000, 64, 32, 8),
    (250_000, 128, 64, 6),
    (500_000, 256, 64, 5),
    (1_000_000, 256, 64, 5),
]
# bench.py:1349's secondary ESS shape; the split-merge A/B runs at its (n, d, k_max) (bench.py:1672).
# Its 200 sweeps ran only where the headline ESS tier had failed, a fallback the port has not.
ESS_TIER = (100_000, 64, 32, 200)
ESS_SWEEPS, ESS_SEEDS, ESS_HELDOUT = 300, 3, 4096
SM_SWEEPS, SM_SEEDS = 150, 2  # the split-merge A/B: each arm's sweeps and seeds
HDP_TIER = (1_000_000, 50, 32, 10_000, 3)  # docs, tokens a doc, topics, vocab, timed sweeps
HDP_MORE = 5  # calls of the timed program after it, so perplexity is read after 3 + 5 x 3 sweeps
SMC_TIER = (1_000_000, 256, 64, 16, 8192, 128)  # n, d, k_max, particles, block, warmup rows
TIERS = ("ladder", "fused", "ess", "hdp", "chains", "chains_headline", "config2", "config3", "smc",
         "ess_sm", "baseline")
SMOKE = ("ladder", "fused")

# The sweep's useful work, in operations: the score product of the assignment
# (kernel 1), 2 N K D^2, and the scatter of the restat (kernel 2), 2 N D^2 (each
# row's outer product lands in one cluster). bench.py's 4 N K D^2 counts the
# scatter K times. The peak is the H100's dense TF32 tensor-core rate (NVIDIA's
# data sheet, SXM): the kernels run their products there, as 3xTF32 split products.
PEAK_TFLOPS = 495.0

_TAIL_KEYS = (
    "summary", "partial", "total_s", "baseline_sweeps_per_s",
    "baseline_range", "ess_per_s", "ess_per_s_spread", "k_active",
    "tflops", "mfu", "peak_tflops", "device", "vs_baseline", "unit", "value", "metric",
)


def _compact_summary(result):
    """One-liners of every sub-tier (bench.py:110-184, unchanged)."""
    s = {}

    def g(d, *ks):
        for k in ks:
            d = d.get(k) if isinstance(d, dict) else None
        return d

    if result.get("ess_tier"):
        t = result["ess_tier"]
        s["ess"] = {
            "shape": [t.get("n"), t.get("d"), t.get("k_max")],
            "sweeps": t.get("sweeps"),
            "n_seeds": t.get("n_seeds"),
            "ess_per_s": t.get("ess_per_s"),
            "spread": t.get("ess_per_s_spread"),
            "kernel": t.get("kernel"),
        }
        if t.get("stalled_seeds"):
            s["ess"]["stalled_seeds"] = t["stalled_seeds"]
        if t.get("seeds_truncated"):
            s["ess"]["seeds_truncated"] = True
    if result.get("predictive"):
        s["predictive"] = result["predictive"]
    if result.get("hdp"):
        h = result["hdp"]
        s["hdp"] = {
            "tokens_per_s": h.get("tokens_per_s"),
            "perplexity": g(h, "predictive", "perplexity"),
        }
    if result.get("smc"):
        m = result["smc"]
        s["smc"] = {
            "n": m.get("n"), "d": m.get("d"),
            "particles": m.get("particles"),
            "rows_per_s": m.get("rows_per_s"), "logz": m.get("logz"),
            "logz_degenerate": g(m, "logz_health", "logz_degenerate"),
            "heldout_logp_dim": g(m, "predictive", "per_dim"),
        }
    for cfg in ("config2", "config3"):
        c = g(result, "configs", cfg)
        if c:
            s[cfg] = {
                "sweeps_per_s": c.get("sweeps_per_s"),
                "fused_sweeps_per_s": g(c, "fused", "sweeps_per_s"),
                "predictive": g(c, "predictive", "mean_logp"),
            }
            s[cfg] = {k: v for k, v in s[cfg].items() if v is not None}
    eff = result.get("efficiency")
    if eff:
        s["efficiency"] = {
            "cpu_mesh_collectives_ok": g(
                eff, "cpu_mesh_shards", "collectives_ok"
            ),
            "chains_on_chip": g(eff, "chains_on_chip", "efficiency"),
        }
    ft = result.get("fused_tier")
    if ft:
        s["fused"] = {"sweeps_per_s": ft.get("sweeps_per_s")}
    ch = result.get("chains_headline")
    if ch:
        s["chains_headline"] = {
            c: v.get("aggregate_chain_sweeps_per_s")
            for c, v in (ch.get("chains") or {}).items()
        }
        s["chains_headline"]["vs_single"] = ch.get("vs_single_chain")
    sm = result.get("ess_tier_sm")
    if sm:
        s["ess_sm"] = {
            "ess_per_s": sm.get("ess_per_s"),
            "spread": sm.get("ess_per_s_spread"),
            "vs_plain": sm.get("ab_plain_ess_per_s"),
        }
    return s


def _ordered_for_tail(result):
    """Reorder so the headline scalars are the FINAL dict entries (bench.py:187-196)."""
    out = {k: v for k, v in result.items() if k not in _TAIL_KEYS}
    out["summary"] = _compact_summary(result)
    for k in _TAIL_KEYS:
        if k == "summary":
            continue
        if k in result:
            out[k] = result[k]
    return out


# ---------------------------------------------------------------------------
# devices, seeds, counts
# ---------------------------------------------------------------------------
def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card; name --device cpu to run on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device):
    """(fn(), its seconds), the card synchronised before and after: the
    window's only host wait is at its end."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _rows_rng(seed: int, *tags: int) -> np.random.Generator:
    """The numpy stream of one tier's data: (seed, tags) as in bench.py's fold_in chains."""
    return np.random.default_rng([seed, *tags])


def _generator(dev: torch.device, seed: int, *tags: int) -> torch.Generator:
    """A torch generator on `dev` seeded from (seed, tags); made anew, it replays."""
    g = torch.Generator(device=dev)
    g.manual_seed(int(np.random.SeedSequence([seed, *tags]).generate_state(1, np.uint64)[0] >> 1))
    return g


_KERNELS = {
    "gaussian_assign": gaussian_assign.fused_gaussian_assign,
    "gaussian_assign_chains": gaussian_assign.fused_gaussian_assign_chains,
    "linear_assign": linear_assign.fused_linear_assign,
    "scatter_stats": suffstat.fused_scatter_stats,
    "hdp_assign": hdp_assign.hdp_assign,
}


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in _KERNELS.items()}


def _launched_since(before: dict) -> dict:
    """Each kernel's launches since `before` (a `_launch_counts()`); 0 on the CPU."""
    return {name: fn.launches - before[name] for name, fn in _KERNELS.items()}


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data recipes, numpy from the seed
# ---------------------------------------------------------------------------
def mixture_rows(rng: np.random.Generator, n: int, d: int, n_true: int = 8) -> np.ndarray:
    """[n, d] float32 rows: n_true centers at scale 4 plus unit noise (bench.py:227-236)."""
    centers = 4.0 * rng.standard_normal((n_true, d), dtype=np.float32)
    x = centers[rng.integers(0, n_true, n)]
    x += rng.standard_normal((n, d), dtype=np.float32)
    return x


def binary_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """[n, d] 0/1 float32 rows of 8 planted Beta(0.5, 0.5) profiles (bench.py:781-786)."""
    probs = rng.beta(0.5, 0.5, size=(8, d))
    return (rng.random((n, d)) < probs[rng.integers(0, 8, n)]).astype(np.float32)


def mixed_rows(rng: np.random.Generator, n: int, d_niw: int = 16):
    """Config 3's float32 columns (xg [n, d_niw], xp [n], xb [n]) of 8 planted
    clusters: niw around centers at scale 4, gp at rates exp(N(0, 1)), bb at
    p ~ Beta(0.5, 0.5) (bench.py:919-932)."""
    z = rng.integers(0, 8, n)
    centers = 4.0 * rng.normal(size=(8, d_niw))
    xg = centers[z] + rng.normal(size=(n, d_niw))
    xp = rng.poisson(np.exp(rng.normal(size=8))[z])
    xb = rng.random(n) < rng.beta(0.5, 0.5, size=8)[z]
    return xg.astype(np.float32), xp.astype(np.float32), xb.astype(np.float32)


def hdp_corpus(rng: np.random.Generator, n_docs: int, doc_len: int, vocab: int,
               heldout_frac: float, blocks: int = 4):
    """(words [D, L] int64, held [D, L] bool): doc d draws its words uniformly
    from vocab block d % blocks; heldout_frac of the positions held out
    (bench.py:1032-1043)."""
    block = vocab // blocks
    words = (np.arange(n_docs) % blocks)[:, None] * block + rng.integers(0, block, (n_docs, doc_len))
    held = rng.random((n_docs, doc_len)) < heldout_frac
    return words, held


def _niw_hyper(d: int) -> dict:
    return {"mu0": np.zeros(d, np.float32), "kappa": 1.0, "psi": np.eye(d, dtype=np.float32),
            "nu": float(d + 2)}


def _columns(x: np.ndarray, dev: torch.device):
    t = torch.from_numpy(x).to(dev)
    return ((t, torch.ones(t.shape[0], device=dev)),)


def _predictive(s, heldout, d: int) -> dict:
    """Mean held-out log density of `heldout` under `s` (outside any timed window)."""
    mean_lp = float(st.heldout_logp(s, heldout).mean())
    return {"heldout_rows": int(heldout[0][0].shape[0]), "mean_logp": round(mean_lp, 4),
            "per_dim": round(mean_lp / d, 5)}


# ---------------------------------------------------------------------------
# the main path's tiers
# ---------------------------------------------------------------------------
def _step_fn(kernel: str):
    """One sweep of `kernel`: "blocked" (plain tensor ops), "fused" (kernels 1
    and 2) or "fused+sm" (the fused sweep, then 2 split-merge moves)."""
    if kernel == "blocked":
        return blocked.sweep
    if kernel == "fused":
        return blocked.sweep_fused
    if kernel == "fused+sm":
        def step(s, data, gen):
            # the Jain-Neal chaser of bench.py:302-312: cluster-level moves a single-site sweep cannot make
            return splitmerge.moves(blocked.sweep_fused(s, data, gen), data, gen, n_moves=2, t_scans=3)

        return step
    raise ValueError(f"unknown kernel {kernel!r}")


def build_tier_fn(n, d, k_max, sweeps, kernel="blocked", heldout=0, multi_stat=False, device="cuda"):
    """(setup, run) of a tier, bench.py:246-322's pair.

    setup(seed, *tags) makes n + heldout rows from one draw (held-out rows
    from the same mixture), the CRP start, and returns (data, heldout data,
    state). run(data, state, gen) runs `sweeps` sweeps with a per-sweep
    trace of score_joint ([sweeps]), or of (score_joint, k_active)
    ([sweeps, 2]) with multi_stat, kept on the device: no host wait.
    """
    dev = _device(device)
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    step = _step_fn(kernel)

    def setup(seed, *tags):
        x_all = mixture_rows(_rows_rng(seed, *tags, 0), n + heldout, d)
        data, held = _columns(x_all[:n], dev), _columns(x_all[n:], dev)
        s = st.initialize(defn, data, _generator(dev, seed, *tags, 1), cluster_hp={"alpha": 1.0},
                          feature_hps=[_niw_hyper(d)])
        return data, held, s

    def run(data, s, gen):
        trace = []
        for _ in range(sweeps):
            s = step(s, data, gen)
            score = st.score_joint(s)
            trace.append(torch.stack([score, (s.counts > 0).sum().to(score.dtype)]) if multi_stat else score)
        return s, torch.stack(trace)

    return setup, run


def _capped_ess(trace, n_samples):
    """Bulk ESS capped at the sample count (bench.py:325-346).

    Traces shorter than 20 samples return None. The first 20% of the trace
    is discarded as burn-in; callers divide by the full run time.
    """
    if n_samples < 20:
        return None
    kept = trace[int(0.2 * len(trace)):]
    e = float(diagnostics.ess(kept - kept.mean()))
    if not np.isfinite(e):
        return None
    return min(e, float(len(kept)))


def _sweep_tflops(n, d, k_max, sweeps_per_s) -> float:
    """TFLOP/s of the sweep's useful work (see PEAK_TFLOPS): 2 N K D^2 + 2 N D^2 a sweep."""
    return (2.0 * n * k_max * d * d + 2.0 * n * d * d) * sweeps_per_s / 1e12


def run_tier(n, d, k_max, sweeps, seed, kernel="blocked", heldout=0, tag=17, device="cuda"):
    """One ladder (or fused) tier, bench.py:349-424: set-up, a warm-up run, then
    a timed run from the same start and generator seed, the card synchronised
    around it. heldout > 0 adds `predictive`, scored outside the timed window."""
    dev = _device(device)
    setup, run = build_tier_fn(n, d, k_max, sweeps, kernel, heldout, device=dev)
    before = _launch_counts()
    (data, held, s), setup_s = _timed(lambda: setup(seed, tag), dev)
    _, warmup_s = _timed(lambda: run(data, s, _generator(dev, seed, tag, 2)), dev)
    (s_out, trace), dt = _timed(lambda: run(data, s, _generator(dev, seed, tag, 2)), dev)
    trace = trace.double().cpu().numpy()
    ess_est = _capped_ess(trace, sweeps)
    ess_per_s = None if ess_est is None else ess_est / dt
    tflops = _sweep_tflops(n, d, k_max, sweeps / dt)
    return {
        "n": n,
        "d": d,
        "k_max": k_max,
        "kernel": kernel,
        "sweeps": sweeps,
        "sweeps_per_s": sweeps / dt,
        "run_s": dt,
        "warmup_s": warmup_s,
        "setup_s": setup_s,
        "ess_est": None if ess_est is None else round(ess_est, 2),
        "ess_per_s": None if ess_per_s is None else round(ess_per_s, 4),
        "tflops": round(tflops, 2),
        "mfu": round(tflops / PEAK_TFLOPS, 4),
        "peak_tflops": PEAK_TFLOPS,
        "k_active": int((s_out.counts > 0).sum()),
        "score_final": float(trace[-1]),
        "predictive": _predictive(s_out, held, d) if heldout else None,
        "launches": _launched_since(before),
    }


def run_ess_tier(n, d, k_max, seed, sweeps=300, n_seeds=2, kernel="fused", heldout=4096, tag=7,
                 device="cuda"):
    """ESS/s with its spread over seeds, bench.py:446-572.

    Each seed has its own data draw and CRP start and runs `sweeps` sweeps
    recording (score_joint, k_active) a sweep; its ESS is the smaller of the
    two statistics' (a flat trace is left out), divided by that seed's whole
    run time. No warm-up run: the first seed carries any one-time cost, and
    the spread shows it. Every seed counts. Each seed's final state is scored
    on its own held-out rows (`heldout_per_dim`, outside the timed window);
    `predictive` is the last seed's, as bench.py reports it.
    """
    dev = _device(device)
    setup, run = build_tier_fn(n, d, k_max, sweeps, kernel, heldout, multi_stat=True, device=dev)
    before = _launch_counts()
    seeds_out, setup_s = [], []
    for i in range(n_seeds):
        (data, held, s), seconds = _timed(lambda: setup(seed, tag, 100 + i), dev)
        setup_s.append(seconds)
        gen = _generator(dev, seed, tag, 100 + i, 2)
        (s_out, trace), dt = _timed(lambda: run(data, s, gen), dev)
        del data
        trace = trace.double().cpu().numpy()  # [sweeps, 2]
        stats = {"score_joint": trace[:, 0], "k_active": trace[:, 1]}
        ess_by_stat = {}
        for name, tr in stats.items():
            # a constant trace (k_active pinned) carries no autocorrelation information
            ess_by_stat[name] = None if np.ptp(tr) == 0.0 else _capped_ess(tr, sweeps)
        finite = [v for v in ess_by_stat.values() if v is not None]
        ess_min = min(finite) if finite else None
        predictive = _predictive(s_out, held, d) if heldout else None
        seeds_out.append({
            "run_s": round(dt, 2),
            "sweeps_per_s": round(sweeps / dt, 4),
            "ess_by_stat": {k: (None if v is None else round(v, 2)) for k, v in ess_by_stat.items()},
            "ess_min": None if ess_min is None else round(ess_min, 2),
            "ess_per_s": None if ess_min is None else round(ess_min / dt, 4),
            "k_active": int((s_out.counts > 0).sum()),
            "score_final": float(trace[-1, 0]),
            "heldout_per_dim": None if predictive is None else predictive["per_dim"],
        })

    vals = [so["ess_per_s"] for so in seeds_out if so["ess_per_s"] is not None]
    mean_dt = float(np.mean([so["run_s"] for so in seeds_out]))
    return {
        "n": n, "d": d, "k_max": k_max, "kernel": kernel,
        "sweeps": sweeps, "n_seeds": n_seeds,
        "sweeps_per_s": round(sweeps / mean_dt, 4),
        "setup_s": round(float(np.mean(setup_s)), 1),
        "seeds": seeds_out,
        "ess_per_s": round(float(np.mean(vals)), 4) if vals else None,
        "ess_per_s_spread": round(float(max(vals) - min(vals)), 4) if len(vals) > 1 else None,
        "ess_est": seeds_out[-1]["ess_min"],
        "k_active": seeds_out[-1]["k_active"],
        "score_final": seeds_out[-1]["score_final"],
        "predictive": predictive,
        "launches": _launched_since(before),
    }


# ---------------------------------------------------------------------------
# path A: chains on one card (kernel 4)
# ---------------------------------------------------------------------------
def _chain_states(defn, data, gen, c, d):
    return stack_states([st.initialize(defn, data, gen, cluster_hp={"alpha": 1.0}, feature_hps=[_niw_hyper(d)])
                         for _ in range(c)])


def _timed_chain_runs(states, data, sweeps, repeats, dev, seed, *tags):
    """A warm-up run, then `repeats` timed runs, each `sweeps` fused
    `sweep_chains` calls from the same start and generator seed; (sorted
    seconds, final states)."""
    def run():
        gen, ss = _generator(dev, seed, *tags), states
        for _ in range(sweeps):
            ss = blocked.sweep_chains(ss, data, gen, fused=True)
        return ss

    _, warmup_s = _timed(run, dev)
    times = []
    for _ in range(repeats):
        out, seconds = _timed(run, dev)
        times.append(seconds)
    return sorted(times), warmup_s, out


def run_chain_scaling_tier(seed, n=65536, d=16, k_max=16, sweeps=40, chain_counts=(1, 2, 4), repeats=3,
                           device="cuda"):
    """Chain-sweeps/s of C chains on one card at fixed per-chain work,
    bench.py:575-672, on `sweep_chains(fused=True)`: the multi-chain
    assignment kernel reads X once for all C chains. Median of `repeats`."""
    dev = _device(device)
    before = _launch_counts()
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    data = _columns(mixture_rows(_rows_rng(seed, 11, 0), n, d), dev)
    throughput = {}
    for c in chain_counts:
        states = _chain_states(defn, data, _generator(dev, seed, 11, c), c, d)
        times, _, _ = _timed_chain_runs(states, data, sweeps, repeats, dev, seed, 11, c, 2)
        throughput[c] = c * sweeps / times[len(times) // 2]

    cs = sorted(chain_counts)
    lo, hi = cs[0], cs[-1]
    # per-sweep cost model t(C) = latency + per_chain * C (least squares)
    t_per_sweep = {c: c / throughput[c] * 1e3 for c in cs}  # ms
    A = np.stack([np.ones(len(cs)), np.asarray(cs, float)], axis=1)
    (lat_ms, per_chain_ms), *_ = np.linalg.lstsq(A, np.asarray([t_per_sweep[c] for c in cs]), rcond=None)
    return {
        "mode": "sweep_chains(fused=True), the multi-chain assignment kernel, one card",
        "n": n, "d": d, "k_max": k_max, "sweeps": sweeps,
        "chain_sweeps_per_s": {str(c): round(v, 2) for c, v in throughput.items()},
        "efficiency": round((throughput[hi] / throughput[lo]) / (hi / lo), 4),
        "sweep_ms_model": {
            "latency_ms": round(float(lat_ms), 3),
            "per_chain_ms": round(float(per_chain_ms), 3),
            "note": "t(C) ~ latency + per_chain*C, host-timed over the run",
        },
        "launches": _launched_since(before),
    }


def run_chains_headline_tier(seed, n, d, k_max, chain_counts=(4,), sweeps=5, repeats=3, device="cuda"):
    """Multi-chain throughput at the headline shape, bench.py:675-756, on
    `sweep_chains(fused=True)` (kernel 4). Median of `repeats`."""
    dev = _device(device)
    before = _launch_counts()
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    data = _columns(mixture_rows(_rows_rng(seed, 13, 0), n, d), dev)
    out_by_c = {}
    for c in chain_counts:
        states = _chain_states(defn, data, _generator(dev, seed, 13, c), c, d)
        times, warmup_s, out = _timed_chain_runs(states, data, sweeps, repeats, dev, seed, 13, c, 2)
        agg = c * sweeps / times[len(times) // 2]
        out_by_c[str(c)] = {
            "aggregate_chain_sweeps_per_s": round(agg, 3),
            "per_chain_sweeps_per_s": round(agg / c, 3),
            "warmup_s": round(warmup_s, 1),
            "k_active_per_chain": [int(v) for v in (out.counts > 0).sum(-1)],
        }
    return {
        "mode": "sweep_chains(fused=True), the multi-chain assignment kernel",
        "n": n, "d": d, "k_max": k_max, "sweeps": sweeps,
        "chains": out_by_c,
        "launches": _launched_since(before),
    }


# ---------------------------------------------------------------------------
# configs 2 and 3
# ---------------------------------------------------------------------------
def _timed_iterations(body, state, iters, dev, seed, *tags):
    """A warm-up run and a timed run of `iters` iterations of body(s, gen)
    from one start and generator seed; (state, score trace, seconds, warm-up seconds)."""
    def run():
        gen, s, trace = _generator(dev, seed, *tags), state, []
        for _ in range(iters):
            s = body(s, gen)
            trace.append(st.score_joint(s))
        return s, torch.stack(trace)

    _, warmup_s = _timed(run, dev)
    (out, trace), dt = _timed(run, dev)
    return out, trace.double().cpu().numpy(), dt, warmup_s


def config2_hp_specs():
    """Config 2's slice-sampler settings (bench.py:800-807): Exp(1) priors,
    Beta hypers bounded to (0.5, 50) so that the uncollapsed sampler's
    empty-slot draws stay moderate, the CRP alpha in (1e-4, 1e4)."""
    beta_hp = {"prior": scalar_functions.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)}
    return {"specs": {0: {"alpha": beta_hp, "beta": beta_hp}},
            "cluster": {"prior": scalar_functions.log_exponential(1.0), "w": 0.5, "bounds": (1e-4, 1e4)}}


def run_config2_tier(seed, n=100_000, d=64, k_max=32, sweeps=8, heldout=4096, device="cuda"):
    """BASELINE config 2, bench.py:759-900: a Beta-Bernoulli DPMM on [n, d]
    binary rows (one bbv feature), a blocked sweep and the slice-sampled
    hypers an iteration. Times the plain sweep and the fused one (kernel 3)
    from the same start; `predictive` scores the plain chain's final state."""
    dev = _device(device)
    before = _launch_counts()
    x_all = binary_rows(_rows_rng(seed, 21, 0), n + heldout, d)
    data, held = _columns(x_all[:n], dev), _columns(x_all[n:], dev)
    defn = st.model_definition(n, [models.bbv(d)], k_max=k_max)
    state = st.initialize(defn, data, _generator(dev, seed, 21, 1), cluster_hp={"alpha": 1.0},
                          feature_hps=[{"alpha": np.ones(d, np.float32), "beta": np.ones(d, np.float32)}])
    hp_kw = config2_hp_specs()

    def body_of(sweep_fn):
        return lambda s, gen: slice_.hp(sweep_fn(s, data, gen), data, gen, **hp_kw)

    out, trace, dt, warmup_s = _timed_iterations(body_of(blocked.sweep), state, sweeps, dev, seed, 21, 2)
    fout, ftrace, fdt, fwarmup_s = _timed_iterations(body_of(blocked.sweep_fused), state, sweeps, dev, seed,
                                                     21, 2)
    return {
        "config": "2: bb-dpmm + slice hp",
        "n": n, "d": d, "k_max": k_max, "sweeps": sweeps,
        "sweeps_per_s": round(sweeps / dt, 3),
        "warmup_s": round(warmup_s, 1),
        "k_active": int((out.counts > 0).sum()),
        "alpha": float(out.cluster_hp["alpha"]),
        "score_final": float(trace[-1]),
        "fused": {
            "sweeps_per_s": round(sweeps / fdt, 3),
            "warmup_s": round(fwarmup_s, 1),
            "k_active": int((fout.counts > 0).sum()),
            "score_final": float(ftrace[-1]),
            # over the plain sweep (bench.py's XLA variant keeps this name)
            "speedup_vs_xla": round(dt / fdt, 3),
        },
        "predictive": _predictive(out, held, d) if heldout else None,
        "launches": _launched_since(before),
    }


def run_config3_tier(seed, n=100_000, k_max=32, sweeps=4, heldout=2048, device="cuda"):
    """BASELINE config 3, bench.py:903-1007: niw(16) + gp + bb columns, a
    blocked sweep, NUTS on the gp and bb hypers and on the CRP alpha (2
    transitions of depth at most 5 each) an iteration."""
    dev = _device(device)
    before = _launch_counts()
    d_niw = 16
    cols = [torch.from_numpy(a).to(dev) for a in mixed_rows(_rows_rng(seed, 22, 0), n + heldout, d_niw)]
    ones, ones_h = torch.ones(n, device=dev), torch.ones(heldout, device=dev)
    data = tuple((c[:n], ones) for c in cols)
    held = tuple((c[n:], ones_h) for c in cols)
    defn = st.model_definition(n, [models.niw(d_niw), models.gp, models.bb], k_max=k_max)
    state = st.initialize(defn, data, _generator(dev, seed, 22, 1), cluster_hp={"alpha": 1.0},
                          feature_hps=[_niw_hyper(d_niw), {"alpha": 1.0, "inv_beta": 1.0},
                                       {"alpha": 1.0, "beta": 1.0}])
    exp1 = scalar_functions.log_exponential(1.0)
    priors = {1: lambda h: exp1(h["alpha"]) + exp1(h["inv_beta"]),
              2: lambda h: exp1(h["alpha"]) + exp1(h["beta"])}

    def body(s, gen):
        s = blocked.sweep(s, data, gen)
        s = hmc.hp(s, data, gen, priors, num_steps=2, max_depth=5)
        return hmc.cluster_hp(s, gen, exp1, num_steps=2, max_depth=5)

    out, trace, dt, warmup_s = _timed_iterations(body, state, sweeps, dev, seed, 22, 2)
    mean_lp = float(st.heldout_logp(out, held).mean())
    return {
        "config": "3: mixed niw+gp+bb + NUTS hp",
        "n": n, "features": [f"niw{d_niw}", "gp", "bb"], "k_max": k_max,
        "sweeps": sweeps,
        "sweeps_per_s": round(sweeps / dt, 3),
        "warmup_s": round(warmup_s, 1),
        "k_active": int((out.counts > 0).sum()),
        "score_final": float(trace[-1]),
        "alpha": float(out.cluster_hp["alpha"]),
        "predictive": {"heldout_rows": heldout, "mean_logp": round(mean_lp, 4)},
        "launches": _launched_since(before),
    }


# ---------------------------------------------------------------------------
# config 4: HDP-LDA
# ---------------------------------------------------------------------------
def run_hdp_tier(n_docs, doc_len, k_topics, vocab, sweeps, seed, doc_chunk=20_000, heldout_frac=0.01,
                 device="cuda"):
    """Config 4, bench.py:1010-1119: HDP-LDA's dense blocked sweep and the
    CRT beta draw on an n_docs x doc_len corpus over 4 planted vocab blocks.
    A warm-up run and a timed run of `sweeps` sweeps from one start; then
    HDP_MORE more runs from the timed run's end (outside the timed window),
    so `perplexity` is read after sweeps * (1 + HDP_MORE) sweeps (18, the
    JAX record's), with the timed run's own beside it."""
    dev = _device(device)
    before = _launch_counts()
    words_np, held_np = hdp_corpus(_rows_rng(seed, 6, 0), n_docs, doc_len, vocab, heldout_frac)
    words = torch.from_numpy(words_np).to(dev)
    held = torch.from_numpy(held_np).to(dev)
    del words_np, held_np
    mask = (~held).float()
    data = topic.dense_token_data(words, mask)
    state = topic.initialize(data, k_topics, vocab, _generator(dev, seed, 6, 1), n_docs=n_docs)

    def run(s, gen):
        trace = []
        for _ in range(sweeps):
            s = topic.blocked_sweep_dense(s, words, mask, gen, doc_chunk=doc_chunk)
            s = topic.sample_beta(s, gen, max_count=doc_len)
            trace.append(topic.score_joint(s))
        return s, torch.stack(trace)

    _, warmup_s = _timed(lambda: run(state, _generator(dev, seed, 6, 2)), dev)
    (out, trace), dt = _timed(lambda: run(state, _generator(dev, seed, 6, 2)), dev)

    predictive = None
    if heldout_frac > 0:
        idx = torch.nonzero(held.reshape(-1)).flatten()
        held_td = topic.TokenData(words.reshape(-1)[idx], idx // doc_len, torch.ones(idx.shape[0], device=dev))
        ppl_timed = float(topic.perplexity(out, held_td))
        for c in range(HDP_MORE):
            out, _ = run(out, _generator(dev, seed, 6, 50 + c))
        predictive = {
            "heldout_tokens": int(idx.shape[0]),
            "perplexity": round(float(topic.perplexity(out, held_td)), 2),
            "sweeps": sweeps * (1 + HDP_MORE),
            "perplexity_timed": round(ppl_timed, 2),
            "random_perplexity": vocab,
        }
    T = n_docs * doc_len
    return {
        "n_docs": n_docs,
        "tokens": T,
        "k_topics": k_topics,
        "vocab": vocab,
        "sweeps": sweeps,
        "sweeps_per_s": round(sweeps / dt, 3),
        "tokens_per_s": round(T * sweeps / dt, 0),
        "warmup_s": round(warmup_s, 1),
        "k_active": int(out.active_topics()),
        "score_final": float(trace[-1]),
        "predictive": predictive,
        "launches": _launched_since(before),
    }


# ---------------------------------------------------------------------------
# config 5: block-SMC
# ---------------------------------------------------------------------------
def run_smc_tier(n, d, k_max, n_particles, seed, block=4096, warmup=512, heldout=2048, device="cuda"):
    """Config 5, bench.py:1122-1246: `smc.run_blocked` (row-sequential
    warmup rows, then blocks, blocked-Gibbs rejuvenation every step; kernel
    2 on the rebuilds) on the main path's recipe, a warm-up call, then the
    timed one. Reports rows/s, logz with its health, and the weighted
    cloud's held-out density (outside the timed window)."""
    dev = _device(device)
    before = _launch_counts()
    x_all = mixture_rows(_rows_rng(seed, 5, 0), n + heldout, d)
    data, held = _columns(x_all[:n], dev), _columns(x_all[n:], dev)
    del x_all
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    parts = smc.init_particles(defn, data, _generator(dev, seed, 5, 1), n_particles, cluster_hp={"alpha": 1.0},
                               feature_hps=[_niw_hyper(d)])

    def run():
        return smc.run_blocked(parts, data, _generator(dev, seed, 5, 2), block=block, warmup=warmup)

    _, first_s = _timed(run, dev)
    res, dt = _timed(run, dev)
    logz = float(res.logz)
    rows_per_s = n / dt

    # an evidence estimate whose per-step ESS collapsed at most steps is degenerate
    ess_trace = np.asarray(res.ess_trace)
    n_collapsed = int((ess_trace < 2.0).sum())
    logz_health = {
        "min_step_ess": round(float(ess_trace.min()), 2) if ess_trace.size else None,
        "median_step_ess": round(float(np.median(ess_trace)), 2) if ess_trace.size else None,
        "steps_ess_lt2": n_collapsed,
        "steps": int(ess_trace.size),
        "logz_degenerate": bool(n_collapsed > 0.5 * max(ess_trace.size, 1)),
    }

    # held-out density of the weighted cloud: log sum_p w_p p(x* | particle p)
    lw = torch.log_softmax(res.log_w, -1)
    lp = torch.stack([st.heldout_logp(unstack_state(res.particles, i), held) for i in range(n_particles)])
    mean_lp = float(torch.logsumexp(lw[:, None] + lp.to(lw.dtype), 0).mean())
    return {
        "mode": "block-smc",
        "n": n,
        "d": d,
        "k_max": k_max,
        "particles": n_particles,
        "block": block,
        "warmup_rows": warmup,
        "rows_per_s": round(rows_per_s, 1),
        "run_s": round(dt, 3),
        "first_call_s": round(first_s, 1),
        "cold_timed": False,
        "logz": logz,
        "logz_health": logz_health,
        "n_resamples": int(res.n_resamples),
        "extrapolated_1m_rows_s": round(1e6 / rows_per_s, 1),
        "predictive": {"heldout_rows": heldout, "mean_logp": round(mean_lp, 4), "per_dim": round(mean_lp / d, 5)},
        "launches": _launched_since(before),
    }


# ---------------------------------------------------------------------------
# the reference architecture's baseline (bench.py:1249-1338, unchanged)
# ---------------------------------------------------------------------------
def numpy_collapsed_rows_per_s(d, k_active, budget_s=2.5, seed=0,
                               replicates=5):
    """Reference-architecture baseline: sequential per-row collapsed Gibbs.

    Mirrors SURVEY.md §3.2's hot loop: remove row → score all active
    clusters + 1 empty (NIW Student-t predictive via numpy Cholesky) →
    categorical draw → add row.  Per-row cost is independent of total N,
    so the caller scales to full-N sweeps/s.  Returns (median, min, max)
    over `replicates` fixed-budget measurements — the spread is published
    as `baseline_range`.
    """
    from numpy.linalg import cholesky, slogdet
    from scipy.special import gammaln

    def one(seed):
        rng = np.random.default_rng(seed)
        m = 512
        sub = rng.normal(size=(m, d))
        alpha = 1.0
        kappa0, nu0 = 1.0, d + 2.0
        mu0 = np.zeros(d)
        psi0 = np.eye(d)

        z = rng.integers(0, k_active, size=m)
        stats = {}
        for k in range(k_active):
            rows = sub[z == k]
            stats[k] = [len(rows), rows.sum(0), rows.T @ rows]

        def pred_logpdf_all(x, ks):
            out = np.empty(len(ks))
            for i, k in enumerate(ks):
                cnt, sx, sxx = stats.get(
                    k, [0, np.zeros(d), np.zeros((d, d))]
                )
                kn = kappa0 + cnt
                nun = nu0 + cnt
                mun = (kappa0 * mu0 + sx) / kn
                psin = (psi0 + sxx + kappa0 * np.outer(mu0, mu0)
                        - kn * np.outer(mun, mun))
                df = nun - d + 1
                S = psin * (kn + 1) / (kn * df)
                L = cholesky(S)
                y = np.linalg.solve(L, x - mun)
                quad = y @ y
                out[i] = (
                    gammaln((df + d) / 2)
                    - gammaln(df / 2)
                    - 0.5 * d * (np.log(df) + np.log(np.pi))
                    - slogdet(S)[1] / 2
                    - 0.5 * (df + d) * np.log1p(quad / df)
                )
            return out

        t0 = time.perf_counter()
        rows_done = 0
        while time.perf_counter() - t0 < budget_s:
            i = rows_done % m
            xi = sub[i]
            k_old = z[i]
            st_ = stats[k_old]
            st_[0] -= 1
            st_[1] = st_[1] - xi
            st_[2] = st_[2] - np.outer(xi, xi)
            if st_[0] == 0:
                del stats[k_old]
            ks = list(stats) + [max(stats, default=-1) + 1]
            crp = np.array(
                [np.log(stats[k][0]) for k in ks[:-1]] + [np.log(alpha)]
            )
            logp = crp + pred_logpdf_all(xi, ks)
            p = np.exp(logp - logp.max())
            p /= p.sum()
            knew = ks[rng.choice(len(ks), p=p)]
            if knew not in stats:
                stats[knew] = [0, np.zeros(d), np.zeros((d, d))]
            stn = stats[knew]
            stn[0] += 1
            stn[1] = stn[1] + xi
            stn[2] = stn[2] + np.outer(xi, xi)
            z[i] = knew
            rows_done += 1
        return rows_done / (time.perf_counter() - t0)

    vals = [one(seed + r) for r in range(replicates)]
    return float(np.median(vals)), float(np.min(vals)), float(np.max(vals))


# ---------------------------------------------------------------------------
# the schedule (bench.py:1361-1710's order) and the line
# ---------------------------------------------------------------------------
def _publish_top(result, top):
    result.update({
        "metric": f"{top['kernel']} Gibbs sweeps/s, {top['n']}x{top['d']} DPMM-NIW K_max={top['k_max']}",
        "value": round(top["sweeps_per_s"], 4),
        "ess_per_s": top["ess_per_s"],
        "tflops": top["tflops"],
        "mfu": top["mfu"],
        "peak_tflops": top["peak_tflops"],
        "k_active": top["k_active"],
    })


def _run_schedule(args, result, dev, log) -> None:
    """Run the tiers of `args` in bench.py's order, filling `result` as each ends."""
    if args.n or args.d or args.k or args.sweeps:
        ladder = [(args.n or 100_000, args.d or 64, args.k or 32, args.sweeps or 8)]
    elif args.smoke:
        ladder = LADDER[:1]
    else:
        ladder = LADDER
    names = (args.tier,) if args.tier else (SMOKE if args.smoke else TIERS)
    seed = args.seed
    tiers = result["tiers"]
    n, d, k_max, sweeps = ladder[-1]
    top = None

    if "ladder" in names:
        for i, shape in enumerate(ladder):
            log(f"ladder tier {shape}")
            t = run_tier(*shape, seed, tag=17 + i, device=dev)
            tiers.append(t)
            top = t
            _publish_top(result, top)
    if "fused" in names:
        log(f"fused tier {(n, d, k_max, sweeps)}")
        fused = run_tier(n, d, k_max, sweeps, seed, kernel="fused", tag=99, device=dev)
        result["fused_tier"] = fused
        if top is None or fused["sweeps_per_s"] > top["sweeps_per_s"]:
            tiers.append(fused)
            top = fused
        _publish_top(result, top)
    if "ess" in names:
        log(f"ess tier {(n, d, k_max)}: {ESS_SEEDS} seeds x {ESS_SWEEPS} sweeps")
        et = run_ess_tier(n, d, k_max, seed, sweeps=ESS_SWEEPS, n_seeds=ESS_SEEDS, heldout=ESS_HELDOUT,
                          device=dev)
        result["ess_tier"] = et
        result.update({k: et[k] for k in ("ess_per_s", "ess_per_s_spread", "ess_est", "predictive")})
    if "hdp" in names:
        log(f"hdp tier {HDP_TIER}")
        result["hdp"] = run_hdp_tier(*HDP_TIER, seed, device=dev)
    if "chains" in names:
        log("chain scaling tier")
        result["efficiency"] = {"chains_on_chip": run_chain_scaling_tier(seed, device=dev)}
    if "chains_headline" in names:
        log(f"chains headline tier {(n, d, k_max)}")
        ch = run_chains_headline_tier(seed, n, d, k_max, device=dev)
        best = max(v["aggregate_chain_sweeps_per_s"] for v in ch["chains"].values())
        ch["vs_single_chain"] = round(best / top["sweeps_per_s"], 3) if top else None
        result["chains_headline"] = ch
    if "config2" in names:
        log("config 2 tier")
        result["configs"]["config2"] = run_config2_tier(seed, device=dev)
    if "config3" in names:
        log("config 3 tier")
        result["configs"]["config3"] = run_config3_tier(seed, device=dev)
    if "smc" in names:
        log(f"smc tier {SMC_TIER}")
        n5, d5, k5, p5, block5, warmup5 = SMC_TIER
        result["smc"] = run_smc_tier(n5, d5, k5, p5, seed, block=block5, warmup=warmup5, device=dev)
    if "ess_sm" in names:
        log(f"split-merge A/B {ESS_TIER[:3]}: {SM_SEEDS} seeds x {SM_SWEEPS} sweeps an arm")
        sm = run_ess_tier(*ESS_TIER[:3], seed, sweeps=SM_SWEEPS, n_seeds=SM_SEEDS, kernel="fused+sm",
                          heldout=0, tag=8, device=dev)
        pl = run_ess_tier(*ESS_TIER[:3], seed, sweeps=SM_SWEEPS, n_seeds=SM_SEEDS, kernel="fused",
                          heldout=0, tag=8, device=dev)
        sm["ab_plain_ess_per_s"] = pl["ess_per_s"]
        sm["ab_plain_spread"] = pl["ess_per_s_spread"]
        sm["ab_plain_sweeps_per_s"] = pl["sweeps_per_s"]
        result["ess_tier_sm"] = sm
    if "baseline" in names:
        log("numpy baseline")
        ref = top or {"d": 16, "k_active": 8, "n": 20000}
        med, lo, hi = numpy_collapsed_rows_per_s(ref["d"], max(ref.get("k_active", 8), 2))
        base = med / ref["n"]
        result["baseline"] = ("reference-architecture per-row collapsed Gibbs (numpy), "
                              "median of 5 fixed-budget replicates, scaled to full N")
        result["baseline_sweeps_per_s"] = float(f"{base:.3e}")
        result["baseline_range"] = [float(f"{lo / ref['n']:.3e}"), float(f"{hi / ref['n']:.3e}")]
        if result.get("value"):
            result["vs_baseline"] = round(result["value"] / base, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="the first ladder shape and its fused tier")
    ap.add_argument("--tier", choices=TIERS, default=None, help="run this tier alone")
    ap.add_argument("--seed", type=int, default=0, help="seed of every tier's data, start and draws")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--d", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--sweeps", type=int, default=None)
    args = ap.parse_args(argv)

    def log(msg):
        print(f"# {msg} ({time.perf_counter() - t_start:.1f} s)", file=sys.stderr, flush=True)

    t_start = time.perf_counter()
    dev = _device(args.device)
    result = {
        "metric": "blocked Gibbs sweeps/s (no tier completed)",
        "value": None,
        "unit": "sweeps/s",
        "vs_baseline": None,
        "device": _card_line() if dev.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "seed": args.seed,
        "fused_tier": None,
        "ess_tier": None,
        "hdp": None,
        "smc": None,
        "configs": {},
        "chains_headline": None,
        "tiers": [],
    }
    if dev.type == "cuda":
        t0 = time.perf_counter()
        _build.library()
        result["build_s"] = round(time.perf_counter() - t0, 1)
    rc = 0
    try:
        _run_schedule(args, result, dev, log)
    except Exception:  # the run ends at the first tier that raises; print what completed
        traceback.print_exc()
        rc = 1
    result["partial"] = bool(rc)
    result["total_s"] = round(time.perf_counter() - t_start, 1)
    print(json.dumps(_ordered_for_tail(result)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
