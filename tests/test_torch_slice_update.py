"""The slice update of one hyper coordinate (`ops/slice_update.py`) on the CPU.

`slice_.hp` hands a bbv feature's Beta hypers and the CRP concentration
under `log_exponential` priors to `slice_update`, whose CPU route is the
kernel's plain version (`slice_update_plain`, its tests host `if`s). Here
its updates are held to the exact conditional on a float64 grid (scipy's
gammaln and betaln, not the target's own code), its caps and bounds are
checked, the route is shown to follow the likelihood and the prior, and
`hp` keeps the benchmark's capture contract: one `slice_sample` call a
coordinate, each drawing its level with `uniform_open` first.
"""

import ast
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import special as spx
from scipy import stats as sps

from common_tpu_torch import models, rng
from common_tpu_torch import scalar_functions as sf
from common_tpu_torch import state as st
from common_tpu_torch.kernels import slice_
from common_tpu_torch.likelihoods.base import Likelihood
from common_tpu_torch.likelihoods.bbv import BBV
from common_tpu_torch.ops import slice_update as su
from common_tpu_torch.utils import profiling

torch.set_num_threads(2)

# six slots, one empty; column 1 of three is the one updated
COUNTS = np.array([40, 25, 0, 10, 5, 3], np.int32)
HEADS = np.array([[10, 31, 2], [20, 3, 9], [0, 0, 0], [4, 8, 1], [1, 5, 4], [2, 0, 3]], np.float32)
OTHER = np.array([1.3, 2.2, 0.8], np.float32)
COL, RATE, LO, HI = 1, 1.0, 0.5, 50.0


def _target(kind, counts=COUNTS):
    t = torch.from_numpy
    if kind == su.KIND_CRP:
        return su.HyperTarget(kind, RATE, t(counts))
    return su.HyperTarget(kind, RATE, t(counts), COL, t(OTHER), t(counts.astype(np.float32)), t(HEADS))


def _exact_logpdf(kind, v):
    """The coordinate's log conditional in float64, written apart from the target's code."""
    v = np.asarray(v, np.float64)
    prior = math.log(RATE) - RATE * v
    active = COUNTS > 0
    if kind == su.KIND_CRP:
        n = COUNTS.sum()
        return prior + active.sum() * np.log(v) + spx.gammaln(v) - spx.gammaln(v + n)
    h = HEADS[active, COL].astype(np.float64)
    t = COUNTS[active].astype(np.float64) - h
    other = float(OTHER[COL])
    a, b = (v, other) if kind == su.KIND_ALPHA else (other, v)
    a, b = np.asarray(a)[..., None], np.asarray(b)[..., None]
    return prior + (spx.betaln(a + h, b + t) - spx.betaln(a, b)).sum(-1)


KINDS = {"alpha": (su.KIND_ALPHA, LO, HI, 60.0), "beta": (su.KIND_BETA, LO, HI, 60.0),
         "crp": (su.KIND_CRP, 1e-4, 1e4, 40.0)}


@pytest.mark.parametrize("name", sorted(KINDS))
def test_one_update_from_the_exact_conditional_stays_in_it(name):
    """1500 points drawn from the exact conditional (inverse CDF on a float64
    grid), each moved by one update through `slice_sample`: the moved points
    follow the same law (KS p > 0.001, mean within 4 standard errors), and
    the update moves them (every point, correlation below 0.9)."""
    kind, lo, hi, top = KINDS[name]
    grid = np.linspace(lo, min(hi, top), 400_001)
    logp = _exact_logpdf(kind, grid)
    p = np.exp(logp - logp.max())
    cdf = np.concatenate([[0.0], np.cumsum((p[1:] + p[:-1]) / 2 * np.diff(grid))])
    assert p[-1] / p.max() < 1e-12  # the grid holds the mass
    cdf /= cdf[-1]
    mean = np.trapezoid(grid * p, grid) / np.trapezoid(p, grid)
    sd = math.sqrt(np.trapezoid((grid - mean) ** 2 * p, grid) / np.trapezoid(p, grid))

    m = 1500
    x0 = np.interp(np.random.default_rng(7).random(m), cdf, grid).astype(np.float32)
    g = rng(11, "cpu").generator
    target = _target(kind)
    x1 = np.array([float(slice_.slice_sample(g, torch.tensor(v), target, w=0.5, lower=lo, upper=hi))
                   for v in x0])
    assert np.all((x1 >= np.float32(lo)) & (x1 <= np.float32(hi)))
    assert np.all(x1 != x0) and np.corrcoef(x0, x1)[0, 1] < 0.9
    assert sps.kstest(x1, lambda v: np.interp(v, grid, cdf)).pvalue > 1e-3
    assert abs(x1.mean() - mean) < 4 * sd / math.sqrt(m)


@pytest.mark.parametrize("kind", [su.KIND_ALPHA, su.KIND_CRP])
def test_updates_keep_to_tight_bounds(kind):
    """Bounds well below the conditional's mass: every update stays inside them."""
    g = rng(3, "cpu").generator
    target, x = _target(kind), torch.tensor(0.12)
    for _ in range(200):
        x = slice_.slice_sample(g, x, target, w=0.5, lower=0.1, upper=0.15)
        assert 0.1 <= float(x) <= 0.15


class _Counted:
    """A target that counts its evaluations."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, v):
        self.calls += 1
        return self.fn(v)


def test_the_caps_bound_the_loops(monkeypatch):
    """The plain version's caps. A target falling from x0 on the lower bound,
    the level just below f(x0) and every draw 0.999: each of the 64
    proposals lands near the shrinking upper end, misses, and x0 stays (1
    level, 2 step-out tests and one more at the edge the lower bound holds,
    64 proposals evaluated). A rising target under
    a very low level: each side steps out its 16 steps, and the first
    proposal lands (1 + 2 x 17 + 1 evaluations)."""
    seed = torch.tensor([5], dtype=torch.int32)
    monkeypatch.setattr(su, "slice_draws", lambda seed, count: torch.full((count,), 0.999))
    falling = _Counted(_target(su.KIND_CRP, np.zeros(4, np.int32)))  # K+ 0: the prior alone
    level = torch.tensor(1.0 - 2.0 ** -23)
    x1 = su.slice_update_plain(torch.tensor(0.5), level, seed, falling, 1.0, 0.5, 10.0, 16, 64)
    assert float(x1) == 0.5 and falling.calls == 1 + 2 + 1 + 64

    rising = _Counted(lambda v: torch.as_tensor(v, dtype=torch.float64))
    x1 = su.slice_update_plain(torch.tensor(0.0), torch.tensor(1e-30), seed, rising, 0.25, -math.inf, math.inf,
                               16, 64)
    assert rising.calls == 1 + 2 * (1 + 16) + 1
    assert -0.25 * 17 <= float(x1) <= 0.25 * 17


def _bbv_state(d=3, n=60, seed=0):
    r = np.random.default_rng(seed)
    X = (r.random((n, d)) < np.where(np.arange(n)[:, None] < n // 2, 0.8, 0.2)).astype(np.float32)
    data = ((torch.from_numpy(X), torch.ones(n)),)
    defn = st.model_definition(n, [models.bbv(d)], k_max=4)
    s = st.initialize(defn, data, rng(seed, "cpu").generator, cluster_hp={"alpha": 1.0},
                      assignment=(np.arange(n) >= n // 2).astype(np.int32))
    return s, data


def _dd_state(n=40, c=3):
    r = np.random.default_rng(1)
    data = ((torch.from_numpy(r.integers(0, c, n).astype(np.int32)), torch.ones(n)),)
    defn = st.model_definition(n, [models.dd(c)], k_max=4)
    s = st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.0},
                      assignment=(np.arange(n) % 2).astype(np.int32))
    return s, data


def _spec(prior):
    return {"prior": prior, "w": 0.5, "bounds": (0.5, 50.0)}


ROUTES = {
    "bbv_exponential": (_bbv_state, {0: {"alpha": _spec(sf.log_exponential(1.0))}}, None, 3),
    "bbv_callable": (_bbv_state, {0: {"alpha": _spec(lambda v: -v)}}, None, 0),
    "bbv_gamma": (_bbv_state, {0: {"beta": _spec(sf.log_gamma(2.0, 1.0))}}, None, 0),
    "dd_exponential": (_dd_state, {0: {"alphas": _spec(sf.log_exponential(1.0))}}, None, 0),
    "crp_exponential": (_bbv_state, {}, _spec(sf.log_exponential(1.0)), 1),
    "crp_gamma": (_bbv_state, {}, _spec(sf.log_gamma(2.0, 1.0)), 0),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_the_route_follows_the_likelihood_and_the_prior(case):
    """bbv's Beta hypers and the CRP concentration under `log_exponential`
    take the update of `ops/slice_update.py` (no loop span; on the CPU its
    plain version's tests are the same reads as the loop's); a plain
    callable or a `log_gamma` prior, and dd's hypers, take the host loop."""
    make, specs, cluster, fused = ROUTES[case]
    s, data = make()
    with profiling.recording() as rec:
        slice_.hp(s, data, rng(2, "cpu").generator, specs, cluster=cluster)
    summary, reads = rec.summary(), rec.reads()
    updates = summary["slice.update"]["calls"]
    assert rec.counters.get("slice.fused_updates", 0) == fused
    assert set(reads) == {"slice.step_out", "slice.shrink"}
    assert reads["slice.step_out"] >= 2 * updates and reads["slice.shrink"] >= updates
    assert rec.counters["slice.evals"] > updates
    if fused:
        assert updates == fused and "slice.step_out" not in summary and "slice.shrink" not in summary
    else:
        assert summary["slice.step_out"]["calls"] == 2 * updates and summary["slice.shrink"]["calls"] == updates


def test_hp_keeps_the_capture_contract(monkeypatch):
    """Wrapping `slice_.slice_sample` and `slice_.uniform_open` as the
    benchmark's capture does: one call a coordinate (alpha 0..d-1, beta
    0..d-1, then the concentration, 2d + 1 in all), the first uniform each
    call draws is its level and holds one value, and each new value lies on
    the slice of its level by a float64 recomputation of the target (the
    beta scan given the new alphas)."""
    s, data = _bbv_state(d=4)
    d = 4
    events = []
    real_sample, real_uniform = slice_.slice_sample, slice_.uniform_open

    def sample(*args, **kw):
        events.append(("call", args[1]))
        return real_sample(*args, **kw)

    def uniform(*args, **kw):
        out = real_uniform(*args, **kw)
        events.append(("uniform", out))
        return out

    monkeypatch.setattr(slice_, "slice_sample", sample)
    monkeypatch.setattr(slice_, "uniform_open", uniform)
    spec = _spec(sf.log_exponential(1.0))
    post = slice_.hp(s, data, rng(4, "cpu").generator, {0: {"alpha": spec, "beta": spec}},
                     cluster={**spec, "bounds": (1e-4, 1e4)})
    calls = [i for i, (kind, _) in enumerate(events) if kind == "call"]
    assert len(calls) == 2 * d + 1
    levels = []
    for i in calls:
        kind, u = events[i + 1]
        assert kind == "uniform" and u.numel() == 1
        levels.append(math.log(float(u)))

    n = s.stats[0]["n"].double().numpy()
    heads = s.stats[0]["heads"].double().numpy()
    active = s.counts.numpy() > 0
    pre, new = s.hypers[0], post.hypers[0]

    def column(a, b, c):
        h, t = heads[active, c], n[active] - heads[active, c]
        return (spx.betaln(a + h, b + t) - spx.betaln(a, b)).sum()

    def f(name, v, c):
        if name == "crp":
            counts = s.counts.numpy()
            return -v + active.sum() * math.log(v) + spx.gammaln(v) - spx.gammaln(v + counts.sum())
        a = v if name == "alpha" else float(new["alpha"][c])
        b = float(pre["beta"][c]) if name == "alpha" else v
        return -v + column(a, b, c)

    moves = ([("alpha", float(pre["alpha"][c]), float(new["alpha"][c]), c) for c in range(d)]
             + [("beta", float(pre["beta"][c]), float(new["beta"][c]), c) for c in range(d)]
             + [("crp", float(s.cluster_hp["alpha"]), float(post.cluster_hp["alpha"]), 0)])
    for (name, x0, x1, c), log_u in zip(moves, levels):
        assert x1 != x0
        assert log_u <= f(name, x1, c) - f(name, x0, c) + 1e-9, (name, c)


def _fixed_state():
    s, data = _bbv_state()
    defn = st.model_definition(s.assignments.shape[0], [models.bbv(3)], k_max=4)
    return st.initialize(defn, data, rng(0, "cpu").generator, assignment=s.assignments, fixed=True)


def _float64(s):
    return dataclasses.replace(s, cluster_hp={"alpha": s.cluster_hp["alpha"].double()})


def _feature_target(make, pname, prior, dtype=torch.float32):
    s, _ = make()
    hyper = {k: v.to(dtype) for k, v in s.hypers[0].items()}
    return s, hyper, s.likelihoods()[0].hyper_target(pname, hyper, s.stats[0], s.counts, prior)


def _crp_target(s, prior):
    return s, None, st.crp_hyper_target(s, prior)


EXP, GAMMA = sf.log_exponential(2.0), sf.log_gamma(2.0, 1.0)
TARGETS = {
    "bbv_alpha": lambda: _feature_target(_bbv_state, "alpha", EXP),
    "bbv_beta": lambda: _feature_target(_bbv_state, "beta", EXP),
    "bbv_gamma": lambda: _feature_target(_bbv_state, "alpha", GAMMA),
    "bbv_float64": lambda: _feature_target(_bbv_state, "beta", EXP, torch.float64),
    "dd_exponential": lambda: _feature_target(_dd_state, "alphas", EXP),
    "crp_exponential": lambda: _crp_target(_bbv_state()[0], EXP),
    "crp_gamma": lambda: _crp_target(_bbv_state()[0], GAMMA),
    "crp_float64": lambda: _crp_target(_float64(_bbv_state()[0]), EXP),
    "crp_fixed": lambda: _crp_target(_fixed_state(), EXP),
}


@pytest.mark.parametrize("case", sorted(TARGETS))
def test_the_likelihood_and_the_state_give_the_hyper_targets(case):
    """bbv's float32 Beta hypers and a CRP state's float32 concentration
    under an Exp prior have a `HyperTarget` on the state's own tensors, at
    column 0 with the other hyper fixed; another prior or dtype, dd (which
    inherits the base class's None) and a fixed-K state have none."""
    s, hyper, target = TARGETS[case]()
    if case in ("bbv_alpha", "bbv_beta"):
        kind, other = (su.KIND_ALPHA, "beta") if case == "bbv_alpha" else (su.KIND_BETA, "alpha")
        assert (target.kind, target.rate, target.c) == (kind, 2.0, 0)
        assert target.other is hyper[other] and target.counts is s.counts
        assert target.n is s.stats[0]["n"] and target.heads is s.stats[0]["heads"]
    elif case == "crp_exponential":
        assert (target.kind, target.rate) == (su.KIND_CRP, 2.0) and target.counts is s.counts
    else:
        assert target is None


def test_the_slice_sampler_leaves_the_route_to_the_targets_owners():
    """`kernels/slice_.py` imports no likelihood module and no `KIND_*`,
    names no likelihood class, and reads no prior's tag: the likelihood's
    `hyper_target` and `state.crp_hyper_target` decide the route."""
    path = Path(slice_.__file__)
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert not (node.module or "").startswith("common_tpu_torch.likelihoods"), node.module
            assert not [a.name for a in node.names if a.name.startswith("KIND_")]
        elif isinstance(node, ast.Import):
            assert not [a.name for a in node.names if "likelihoods" in a.name]
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert not {n for n in names if n.startswith("KIND_") or n in {"BBV", "Likelihood"}}
    assert "exponential_rate" not in path.read_text()


@pytest.mark.parametrize("case", ["dd", "bbv_without_a_target"])
def test_a_likelihood_without_a_hyper_target_takes_the_loop(case, monkeypatch):
    """A likelihood whose `hyper_target` is None takes the host loop under
    the `log_exponential` prior that sends bbv to the card: dd, and bbv
    itself once its `hyper_target` is the base class's."""
    spec = _spec(sf.log_exponential(1.0))
    if case == "dd":
        (s, data), specs = _dd_state(), {0: {"alphas": spec}}
    else:
        monkeypatch.setattr(BBV, "hyper_target", Likelihood.hyper_target)
        (s, data), specs = _bbv_state(), {0: {"alpha": spec, "beta": spec}}
    with profiling.recording() as rec:
        post = slice_.hp(s, data, rng(3, "cpu").generator, specs)
    summary = rec.summary()
    coords = sum(s.hypers[0][p].shape[0] for p in specs[0])
    assert rec.counters.get("slice.fused_updates", 0) == 0
    assert summary["slice.update"]["calls"] == coords == summary["slice.shrink"]["calls"]
    assert all(torch.isfinite(post.hypers[0][p]).all() for p in specs[0])


def test_bbv_and_the_crp_take_their_targets_under_exponential_priors():
    """Under `log_exponential` priors on alpha, beta and the concentration,
    every one of the 2d + 1 updates of a d-column bbv state takes its
    `HyperTarget`, and no update opens a loop span."""
    d = 5
    s, data = _bbv_state(d=d)
    spec = _spec(sf.log_exponential(1.0))
    with profiling.recording() as rec:
        slice_.hp(s, data, rng(6, "cpu").generator, {0: {"alpha": spec, "beta": spec}},
                  cluster={**spec, "bounds": (1e-4, 1e4)})
    summary = rec.summary()
    assert rec.counters["slice.fused_updates"] == summary["slice.update"]["calls"] == 2 * d + 1
    assert "slice.step_out" not in summary and "slice.shrink" not in summary
