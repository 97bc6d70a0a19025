"""Every Beta parameter the port draws lies inside (0, 1) of its dtype.

A float32 Beta draw G1 / (G1 + G2) rounds to exactly 1 when its second
shape is small against its first: at 10^6 heads and beta = 0.5, about 20%
of draws. log(1 - p) is then -inf, a Bernoulli score 0 * -inf = NaN, and
`torch.argmax` (like `jnp.argmax`) returns the first NaN, so a blocked sweep
moves every affected row into that slot. `rng.beta_open` clamps the draw to
[finfo.tiny, 1 - finfo.eps / 2]; bb, bnb, bbv and bbnc draw through it. The
JAX package draws unclamped: its draws at the same counts hit 1.0 (held here
as the reference's known defect; it is not edited).

The allow-list below names every Beta and Gamma draw of `common_tpu_torch/`
with the reason its value never meets a log of 0 or a division by 0: it is
drawn through `beta_open`, or floored at the draw, or a Gamma draw (at least
finfo.tiny: torch clamps it there, held below) used where that suffices. It
is exact both ways: a new draw call fails the test, and so does an entry
whose call is gone.

A sampler test runs a chain where a cluster holds 10^5 all-heads rows (or
cells), hyper beta = 0.5, from 3 generator seeds x 20 sweeps: before the
clamp each of those chains collapsed to one cluster within the 20 sweeps.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common_tpu import likelihoods as jlik
from common_tpu_torch import likelihoods as tlik
from common_tpu_torch import models
from common_tpu_torch import relational as irm
from common_tpu_torch import state as st
from common_tpu_torch.data import sparse_ndarray_dataview
from common_tpu_torch.kernels import blocked
from common_tpu_torch.relational import kernels as irm_kernels
from common_tpu_torch.rng import beta, beta_open, standard_gamma
from torch_support_cases import BETA, DRAWS, HEADS, NAMES, extreme, scores

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "common_tpu_torch"

SEEDS, SWEEPS = 3, 20  # the sampler tests' chains


def _const(value):
    return torch.full((DRAWS,), value)


@pytest.mark.parametrize("name", NAMES)
def test_sample_params_stays_inside_the_support_at_extreme_counts(name):
    lik, hyper, stats, X, _ = extreme(name)
    theta = lik.sample_params(torch.Generator().manual_seed(0), hyper, stats)
    p = theta["p"]
    assert p.numel() == DRAWS
    assert bool(((p > 0) & (p < 1)).all()), f"{int((p == 1).sum())} draws at 1, {int((p == 0).sum())} at 0"
    assert bool(torch.isfinite(scores(lik, theta, X)).all())


def test_bbnc_refresh_stays_inside_the_support():
    """refresh_latents draws from the prior: Beta(HEADS, 0.5) hits 1 as often as the posterior above."""
    hyper = {"alpha": torch.tensor(HEADS), "beta": torch.tensor(BETA)}
    stats = {"n": _const(0.0), "heads": _const(0.0), "p": _const(0.5)}
    out = tlik.bbnc.refresh_latents(torch.Generator().manual_seed(0), hyper, stats,
                                    torch.ones(DRAWS, dtype=torch.bool))
    p = out["p"]
    assert bool(((p > 0) & (p < 1)).all()), f"{int((p == 1).sum())} draws at 1"


@pytest.mark.parametrize("name", NAMES)
def test_reference_draw_hits_one_at_the_same_counts(name):
    """The JAX package's `sample_params` on the same stats: unclamped, some
    of its float32 draws are exactly 1.0 (its known defect, not repaired)."""
    _, hyper, stats, _, _ = extreme(name)
    jh = {k: jnp.asarray(v.numpy()) for k, v in hyper.items()}
    js = {k: jnp.asarray(v.numpy()) for k, v in stats.items()}
    p = np.asarray(getattr(jlik, name).sample_params(jax.random.key(0), jh, js)["p"])
    assert p.dtype == np.float32 and p.size == DRAWS
    assert (p == 1.0).sum() > 0


def test_beta_open_changes_only_the_draws_on_the_boundary():
    """From one generator state `beta_open` equals `beta` wherever that lies
    inside (0, 1), and puts a draw of 1 at the largest float below 1."""
    a = torch.cat([_const(1.0 + HEADS), torch.rand(DRAWS, generator=torch.Generator().manual_seed(3)) * 5 + 0.1])
    b = torch.cat([_const(BETA), torch.rand(DRAWS, generator=torch.Generator().manual_seed(4)) * 5 + 0.1])
    raw = beta(a, b, torch.Generator().manual_seed(5))
    open_ = beta_open(a, b, torch.Generator().manual_seed(5))
    inside = (raw > 0) & (raw < 1)
    assert int((~inside).sum()) > 0
    assert torch.equal(open_[inside], raw[inside])
    assert torch.equal(open_[raw == 1], torch.full_like(open_[raw == 1], 1.0 - 2.0 ** -24))
    assert float(torch.log1p(-open_).min()) == pytest.approx(-24 * np.log(2.0))
    for dt in (torch.float32, torch.float64):
        x = beta_open(torch.full((4,), 1e30, dtype=dt), torch.full((4,), 1e-30, dtype=dt),
                      torch.Generator().manual_seed(0))
        assert x.dtype == dt and bool((x < 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gamma_draw_is_at_least_tiny(dtype):
    """torch's Gamma sampler clamps its draw at finfo.tiny: the allow-list's
    Gamma reasons rest on it. At shape 1e-3 most draws sit on that floor."""
    g = standard_gamma(torch.full((100_000,), 1e-3, dtype=dtype), torch.Generator().manual_seed(0))
    tiny = torch.finfo(dtype).tiny
    assert float(g.min()) == tiny
    assert bool(torch.isfinite(torch.log(g)).all())


def test_gp_rate_stays_positive_over_a_large_zero_count_cluster():
    """lam = G / (inv_beta + n): at alpha 1e-3 most G sit at finfo.tiny, and over
    10^8 zero counts the ratio underflowed to 0 (a zero count scored NaN)."""
    hyper = {"alpha": torch.tensor(1e-3), "inv_beta": torch.tensor(1.0)}
    stats = {"n": _const(1e8), "sum_x": _const(0.0), "sum_log_fact": _const(0.0)}
    theta = tlik.gp.sample_params(torch.Generator().manual_seed(0), hyper, stats)
    assert bool((theta["lam"] > 0).all())
    assert bool(torch.isfinite(tlik.gp.logpdf_batch(theta, torch.tensor([0.0, 2.0]), torch.ones(2))).all())


# ---------------------------------------------------------------------------
# chains with an all-heads cluster
# ---------------------------------------------------------------------------
def test_blocked_sweep_keeps_its_clusters_over_all_heads_rows():
    """A DPMM of a nich column (two clusters at -5 and 5, 10^5 rows each) and
    a scalar bb column that is all heads: from the planted start, no sweep
    falls to one cluster and score_joint stays finite."""
    n_each = 100_000
    r = np.random.default_rng(0)
    z = np.repeat(np.arange(2, dtype=np.int32), n_each)
    x = np.where(z == 0, -5.0, 5.0) + r.normal(size=z.size)
    ones = torch.ones(z.size)
    data = ((torch.tensor(x, dtype=torch.float32), ones), (ones.clone(), ones))
    defn = st.model_definition(z.size, [models.nich, models.bb], k_max=8)
    for seed in range(SEEDS):
        s = st.initialize(defn, data, torch.Generator().manual_seed(seed), cluster_hp={"alpha": 1.0},
                          feature_hps=[None, {"alpha": 1.0, "beta": BETA}], assignment=z)
        g = torch.Generator().manual_seed(100 + seed)
        for sweep in range(SWEEPS):
            s = blocked.sweep(s, data, g)
            k = int((s.counts > 0).sum())
            assert k > 1, f"seed {seed}, sweep {sweep}: every row in one cluster"
            assert np.isfinite(float(st.score_joint(s)))


def test_irm_blocked_sweep_keeps_its_clusters_over_an_all_ones_block():
    """A 640 x 640 bb relation: every row entity has all ones towards column
    cluster 0 (two blocks of 102,400 ones), row cluster 1 coin flips towards
    column cluster 1, row cluster 0 zeros there. From the planted start no
    domain falls to one cluster and score_joint stays finite."""
    n = 640
    h = n // 2
    r = np.random.default_rng(0)
    rel = np.zeros((n, n), np.float32)
    rel[:, :h] = 1.0
    rel[h:, h:] = r.random((h, h)) < 0.5
    z = np.repeat(np.arange(2, dtype=np.int32), h)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device="cpu")])
    defn = irm.model_definition([n, n], [((0, 1), models.bb)], k_max=8)
    for seed in range(SEEDS):
        s = irm.initialize(defn, views, torch.Generator().manual_seed(seed), cluster_hps=[{"alpha": 1.0}] * 2,
                           relation_hps=[{"alpha": 1.0, "beta": BETA}], domain_assignments=[z, z])
        g = torch.Generator().manual_seed(100 + seed)
        for sweep in range(SWEEPS):
            s = irm_kernels.sweep(s, views, g)
            ks = [int((c > 0).sum()) for c in s.counts]
            assert min(ks) > 1, f"seed {seed}, sweep {sweep}: k_active {ks}"
            assert np.isfinite(float(irm.score_joint(s)))


# ---------------------------------------------------------------------------
# the allow-list of draws
# ---------------------------------------------------------------------------
OPEN = "through rng.beta_open: inside (0, 1) of its dtype"
FLOORED = "clamped into the support at the draw, before any log of it"
LOG_ONLY = "a Gamma draw is at least finfo.tiny, and only logs of it (or of their sum) are taken"
CONCENTRATION = ("a concentration: a Gamma draw (at least finfo.tiny) over a rate at least b > 0 "
                 "(log eta and log w are floored at log 1e-30), so positive and finite")
CHI_SQUARE = ("a chi-square draw of nu_n - i degrees of freedom, at least 2 finfo.tiny: no division by zero "
              "and a finite log; it reaches that floor only at nu_n - i << 1 "
              "(P < 1e-6 a draw for nu_n - i > 0.32)")

# (file, enclosing function, drawing function) -> (calls, reason)
ALLOWED = {
    ("rng.py", "standard_gamma", "_standard_gamma"): (1, "torch's Gamma sampler: at least finfo.tiny"),
    ("rng.py", "beta", "standard_gamma"): (2, "G1 / (G1 + G2) in [0, 1]: only beta_open and the floors below use it"),
    ("rng.py", "beta_open", "beta"): (1, OPEN),
    ("likelihoods/bb.py", "sample_params", "beta_open"): (1, OPEN),
    ("likelihoods/bnb.py", "sample_params", "beta_open"): (1, OPEN),
    ("likelihoods/bbv.py", "sample_params", "beta_open"): (1, OPEN),
    ("likelihoods/bbnc.py", "sample_params", "beta_open"): (1, OPEN),
    ("likelihoods/bbnc.py", "refresh_latents", "beta_open"): (1, OPEN),
    # a Poisson rate G (1 - p) / p, p inside (0, 1) from beta_open: finite and nonnegative
    ("likelihoods/bnb.py", "sample_value", "standard_gamma"): (1, "a Poisson rate over p from beta_open"),
    ("likelihoods/gp.py", "sample_params", "standard_gamma"): (1, FLOORED),  # G / rate floored at finfo.tiny
    ("likelihoods/dd.py", "dirichlet_log", "standard_gamma"): (1, LOG_ONLY),
    ("likelihoods/nich.py", "sample_params", "standard_gamma"): (1, CHI_SQUARE),
    ("likelihoods/niw.py", "sample_params", "standard_gamma"): (1, CHI_SQUARE),
    ("likelihoods/niw.py", "sample_params_prec", "standard_gamma"): (1, CHI_SQUARE),
    # the stick: clamped to [1e-7, 1 - 1e-7], as the JAX package clamps it
    ("kernels/blocked.py", "stick_break_log_weights", "beta"): (1, FLOORED),
    ("kernels/blocked.py", "dirichlet_log_weights", "standard_gamma"): (1, FLOORED),  # w floored at 1e-30
    # Escobar-West: eta floored at 1e-30 before its log; eta = 1 gives log eta = 0
    ("kernels/gibbs.py", "cluster_hp_escobar_west", "beta"): (1, FLOORED),
    ("kernels/gibbs.py", "cluster_hp_escobar_west", "standard_gamma"): (1, CONCENTRATION),
    ("relational/kernels.py", "_escobar_west_draw", "beta"): (1, FLOORED),
    ("relational/kernels.py", "_escobar_west_draw", "standard_gamma"): (1, CONCENTRATION),
    ("topic/hdp.py", "_dirichlet", "standard_gamma"): (1, LOG_ONLY),
    ("topic/hdp.py", "_sample_concentrations", "beta"): (2, FLOORED),  # w and eta floored at 1e-30
    ("topic/hdp.py", "_sample_concentrations", "standard_gamma"): (2, CONCENTRATION),
    # Hoffman's Gamma(100, 100) start of lam: draws near 1, never near 0
    ("topic/svi.py", "init", "standard_gamma"): (1, "Gamma(100) draws, far from 0"),
}

DRAWING = {"beta", "beta_open", "standard_gamma"}  # the draws of common_tpu_torch/rng.py
RAW = {"_standard_gamma", "_sample_dirichlet"}  # torch's own, called anywhere


def _draw_sites():
    """{(file, enclosing function, drawing function): calls} over the package."""
    found = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(PACKAGE).as_posix()
        tree = ast.parse(path.read_text())
        assert "torch.distributions" not in path.read_text(), rel
        # local name -> drawing function: rng.py's own names, or what a module imports from it
        names = {n: n for n in DRAWING} if rel == "rng.py" else {}
        modules = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "common_tpu_torch.rng":
                names.update({a.asname or a.name: a.name for a in node.names if a.name in DRAWING})
            if isinstance(node, ast.Import):
                modules.update(a.asname or a.name for a in node.names if a.name == "common_tpu_torch.rng")

        def drawn(call):
            f = call.func
            if isinstance(f, ast.Name):
                return names.get(f.id)
            if isinstance(f, ast.Attribute):
                if f.attr in RAW:
                    return f.attr
                if f.attr in DRAWING and isinstance(f.value, ast.Name) and f.value.id in modules:
                    return f.attr
            return None

        def visit(node, func):
            for child in ast.iter_child_nodes(node):
                name = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
                if isinstance(child, ast.Call) and (what := drawn(child)):
                    key = (rel, func, what)
                    found[key] = found.get(key, 0) + 1
                visit(child, name)

        visit(tree, "<module>")
    return found


def test_every_beta_and_gamma_draw_is_allowed_with_its_reason():
    assert {k: n for k, (n, _) in ALLOWED.items()} == _draw_sites()
    beta_sites = {k for k in ALLOWED if k[2] == "beta"}
    assert all(ALLOWED[k][1] in (OPEN, FLOORED) for k in beta_sites)
