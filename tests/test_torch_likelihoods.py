"""The port's likelihood zoo against the JAX package, in float64.

One parametrised test per property, over bb, bnb, gp, nich, dd, dm, bbnc,
niw and bbv. The same numpy inputs go through `common_tpu.likelihoods`
(under `jax.enable_x64`) and `common_tpu_torch.likelihoods`.

Tolerances: the scoring functions (`posterior_hyper`, `marginal_loglik`,
`pred_logpdf`, `logpdf`, `prior_logpdf`) take float64 stats and hypers on
both sides and agree to rtol = atol = 1e-9, except where the JAX package
casts the row to float32 before a log-gamma of it (bnb, gp, dm: 1e-6).
`stats_from_assignments` and `tx` agree to rtol = atol = 1e-6: the JAX
package's bb, bnb, gp, dd, dm and bbnc cast rows and suffstats to float32
inside `tx` and `init_stats`. The invariants of
tests/test_likelihoods.py:226-281 hold exactly (an empty slot's marginal,
a masked row's contribution) or to 1e-9 (the chain rule, the batched
calls); NIW's chain rule holds to 1e-5, the size of the relative diagonal
jitter (1e-6 of the mean diagonal) its posterior adds once a slot has data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common_tpu import likelihoods as jlik
from common_tpu_torch import likelihoods as tlik
from common_tpu_torch import models

torch.set_num_threads(2)

SCORE = dict(rtol=1e-9, atol=1e-9)
STATS = dict(rtol=1e-6, atol=1e-6)
K, N = 5, 40


def _dirichlet_log(r, k, c):
    return np.log(r.dirichlet(np.ones(c), size=k))


def _niw_theta(r, k):
    d = 2
    off = np.tril(r.normal(scale=0.3, size=(k, d, d)), -1)
    return {"mu": r.normal(size=(k, d)), "cov_chol": off + np.eye(d) * r.uniform(0.5, 1.5, (k, 1, d))}


# name -> (port descriptor, hypers, row generator, theta generator, conjugate)
CASES = {
    "bb": (models.bb, {"alpha": 1.3, "beta": 0.7},
           lambda r: r.integers(0, 2), lambda r, k: {"p": r.uniform(0.05, 0.95, k)}),
    "bnb": (models.bnb, {"alpha": 2.0, "beta": 3.0, "r": 2.0},
            lambda r: r.integers(0, 6),
            lambda r, k: {"p": r.uniform(0.05, 0.95, k), "r": np.full(k, 2.0)}),
    "gp": (models.gp, {"alpha": 2.0, "inv_beta": 1.5},
           lambda r: r.poisson(3.0), lambda r, k: {"lam": r.uniform(0.5, 5.0, k)}),
    "nich": (models.nich, {"mu": 0.3, "kappa": 1.2, "sigmasq": 0.8, "nu": 2.0},
             lambda r: r.normal(scale=2.0),
             lambda r, k: {"mu": r.normal(size=k), "var": r.uniform(0.3, 3.0, k)}),
    "dd": (models.dd(3), {"alphas": np.array([0.5, 1.0, 2.0])},
           lambda r: r.integers(0, 3), lambda r, k: {"logp": _dirichlet_log(r, k, 3)}),
    "dm": (models.dm(3), {"alphas": np.array([0.5, 1.0, 2.0])},
           lambda r: r.multinomial(5, [0.3, 0.3, 0.4]).astype(np.float64),
           lambda r, k: {"logp": _dirichlet_log(r, k, 3)}),
    "bbnc": (models.bbnc, {"alpha": 1.3, "beta": 0.7},
             lambda r: r.integers(0, 2), lambda r, k: {"p": r.uniform(0.05, 0.95, k)}),
    "niw": (models.niw(2), {"mu0": np.array([0.2, -0.4]), "kappa": 1.7,
                            "psi": np.array([[1.2, 0.3], [0.3, 0.8]]), "nu": 3.5},
            lambda r: r.normal(scale=2.0, size=2), _niw_theta),
    "bbv": (models.bbv(4), {"alpha": np.array([0.5, 1.0, 1.5, 2.0]),
                            "beta": np.array([1.5, 0.7, 1.0, 3.0])},
            lambda r: r.integers(0, 2, size=4).astype(np.float64),
            lambda r, k: {"p": r.uniform(0.05, 0.95, (k, 4))}),
}
NAMES = list(CASES)
CONJUGATE = [n for n in NAMES if n != "bbnc"]
ROW_F32 = {"bnb", "gp", "dm"}  # JAX takes lgamma of the row in float32


def _row_tol(name):
    return STATS if name in ROW_F32 else SCORE


def _jlik(name):
    return jlik.base.get(name)


def _t(d):
    return {k: torch.tensor(np.asarray(v, np.float64)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _rows(name, n, seed):
    gen = CASES[name][2]
    r = np.random.default_rng(seed)
    return np.stack([np.asarray(gen(r)) for _ in range(n)])


def _problem(name, seed=0):
    """f64 hypers, rows, a mask and assignments with slot K-1 empty."""
    hyper = {k: np.asarray(v, np.float64) for k, v in CASES[name][1].items()}
    X = _rows(name, N, seed)
    r = np.random.default_rng(seed + 100)
    mask = (r.random(N) > 0.2).astype(np.float64)
    gid = r.integers(0, K, N).astype(np.int32)
    gid[gid == K - 1] = K  # dropped: slot K-1 stays empty
    return hyper, X, mask, gid


def _stats(name, hyper, X, mask, gid):
    """The port's f64 stats, with bbnc's latent p set to a draw inside (0, 1)."""
    s = tlik.get(name).stats_from_assignments(_t(hyper), torch.from_numpy(X),
                                              torch.from_numpy(mask), torch.from_numpy(gid), K)
    if name == "bbnc":
        s["p"] = torch.tensor(np.random.default_rng(3).uniform(0.05, 0.95, K))
    return _np(s)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


@pytest.mark.parametrize("name", NAMES)
def test_stats_from_assignments_and_tx_match_jax(name):
    hyper, X, mask, gid = _problem(name)
    got = tlik.get(name).stats_from_assignments(_t(hyper), torch.from_numpy(X),
                                                torch.from_numpy(mask), torch.from_numpy(gid), K)
    with jax.enable_x64(True):
        want = _np(_jlik(name).stats_from_assignments(_j(hyper), jnp.asarray(X), jnp.asarray(mask),
                                                      jnp.asarray(gid), K))
        want_tx = _np(_jlik(name).tx(_j(hyper), jnp.asarray(X[4]), jnp.asarray(1.0)))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], STATS, k)
        assert got[k].dtype == torch.float64, k
    tx = tlik.get(name).tx(_t(hyper), torch.tensor(X[4]), torch.tensor(1.0))
    for k in want_tx:
        _close(tx[k], want_tx[k], STATS, k)


@pytest.mark.parametrize("name", [n for n in NAMES if n not in ("bnb", "bbnc")])
def test_posterior_hyper_matches_jax(name):
    """(The JAX package's bnb and bbnc define no posterior_hyper.)"""
    hyper, X, mask, gid = _problem(name, 1)
    stats = _stats(name, hyper, X, mask, gid)
    with jax.enable_x64(True):
        want = _np(_jlik(name).posterior_hyper(_j(hyper), _j(stats)))
    got = tlik.get(name).posterior_hyper(_t(hyper), _t(stats))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], SCORE, k)


@pytest.mark.parametrize("name", NAMES)
def test_marginal_loglik_matches_jax(name):
    hyper, X, mask, gid = _problem(name, 2)
    stats = _stats(name, hyper, X, mask, gid)
    with jax.enable_x64(True):
        want = np.asarray(_jlik(name).marginal_loglik(_j(hyper), _j(stats)))
    got = tlik.get(name).marginal_loglik(_t(hyper), _t(stats))
    assert got.shape == (K,)
    _close(got, want, SCORE)


@pytest.mark.parametrize("name", NAMES)
def test_pred_logpdf_matches_jax(name):
    hyper, X, mask, gid = _problem(name, 3)
    stats = _stats(name, hyper, X, mask, gid)
    for x in _rows(name, 3, 9):
        with jax.enable_x64(True):
            want = np.asarray(_jlik(name).pred_logpdf(_j(hyper), _j(stats), jnp.asarray(x)))
        got = tlik.get(name).pred_logpdf(_t(hyper), _t(stats), torch.tensor(x))
        assert got.shape == (K,)
        _close(got, want, _row_tol(name))


@pytest.mark.parametrize("name", NAMES)
def test_logpdf_and_prior_logpdf_match_jax(name):
    hyper = {k: np.asarray(v, np.float64) for k, v in CASES[name][1].items()}
    theta = CASES[name][3](np.random.default_rng(4), K)
    for x in _rows(name, 3, 10):
        with jax.enable_x64(True):
            want = np.asarray(_jlik(name).logpdf(_j(theta), jnp.asarray(x)))
        _close(tlik.get(name).logpdf(_t(theta), torch.tensor(x)), want, _row_tol(name))
    with jax.enable_x64(True):
        want = np.asarray(_jlik(name).prior_logpdf(_j(hyper), _j(theta)))
    got = tlik.get(name).prior_logpdf(_t(hyper), _t(theta))
    assert got.shape == (K,)
    _close(got, want, SCORE)


@pytest.mark.parametrize("name", CONJUGATE)
def test_empty_marginal_is_exactly_zero(name):
    desc = CASES[name][0]
    hyper = desc.canonical_hyper(dtype=torch.float64, device="cpu")
    ml = desc.likelihood.marginal_loglik(hyper, desc.likelihood.init_stats(hyper, (K,)))
    assert ml.shape == (K,) and torch.equal(ml, torch.zeros(K, dtype=torch.float64))


@pytest.mark.parametrize("name", CONJUGATE)
def test_predictive_chain_rule(name):
    """marginal(D + x) - marginal(D) == pred(D, x) for every conjugate model."""
    lik = tlik.get(name)
    hyper = _t(CASES[name][1])
    stats = lik.init_stats(hyper, ())
    for row in _rows(name, 5, 42):
        stats = tlik.fold(stats, lik.tx(hyper, torch.tensor(row), 1.0), 1.0)
    x = torch.tensor(_rows(name, 1, 43)[0])
    with_x = tlik.fold(stats, lik.tx(hyper, x, 1.0), 1.0)
    lhs = lik.marginal_loglik(hyper, with_x) - lik.marginal_loglik(hyper, stats)
    tol = dict(rtol=1e-5, atol=1e-5) if name == "niw" else SCORE
    _close(lhs, lik.pred_logpdf(hyper, stats, x), tol)


@pytest.mark.parametrize("name", NAMES)
def test_masked_tx_contributes_nothing(name):
    lik = tlik.get(name)
    hyper, X, mask, gid = _problem(name, 5)
    stats = _t(_stats(name, hyper, X, mask, gid))
    th = _t(hyper)
    for k, (a, b) in enumerate(zip(stats.values(), tlik.scatter_fold(
            stats, 2, lik.tx(th, torch.tensor(X[0]), 0.0), 1.0).values())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_batched_stats_broadcast(name):
    """pred/marginal over a [K] batch of stats == per-slot unbatched calls,
    and scatter_fold into slot k == fold of slot k alone."""
    lik = tlik.get(name)
    hyper = _t(CASES[name][1])
    batched = lik.init_stats(hyper, (K,))
    per_slot = [_rows(name, k + 1, 60 + k) for k in range(K)]
    singles = []
    for k, rows in enumerate(per_slot):
        single = lik.init_stats(hyper, ())
        for row in rows:
            tx = lik.tx(hyper, torch.tensor(row), 1.0)
            batched = tlik.scatter_fold(batched, k, tx, 1.0)
            single = tlik.fold(single, tx, 1.0)
        singles.append(single)
    if name == "bbnc":
        batched["p"] = torch.linspace(0.2, 0.8, K, dtype=torch.float64)
        for k, s in enumerate(singles):
            s["p"] = batched["p"][k]
    x = torch.tensor(_rows(name, 1, 99)[0])
    pred = lik.pred_logpdf(hyper, batched, x)
    marg = lik.marginal_loglik(hyper, batched)
    for k, s in enumerate(singles):
        _close(pred[k], lik.pred_logpdf(hyper, s, x), SCORE)
        _close(marg[k], lik.marginal_loglik(hyper, s), SCORE)


@pytest.mark.parametrize("name", NAMES)
def test_grid_lifted_hypers_broadcast(name):
    """A [G, 1, ...] stack of hypers against [K, ...] stats scores every grid
    point at once: the form `kernels.gibbs.hp` uses."""
    lik = tlik.get(name)
    hyper, X, mask, gid = _problem(name, 6)
    stats = _t(_stats(name, hyper, X, mask, gid))
    grid = [_t({k: v * s for k, v in hyper.items()}) for s in (0.7, 1.0, 1.6)]
    if name == "bnb":  # r is fixed, not on the grid
        grid = [{**g, "r": _t(hyper)["r"]} for g in grid]
    lifted = {k: torch.stack([g[k] for g in grid]).unsqueeze(1) for k in grid[0]}
    batched = lik.marginal_loglik(lifted, stats)
    assert batched.shape == (3, K)
    for i, g in enumerate(grid):
        _close(batched[i], lik.marginal_loglik(g, stats), SCORE)


def test_descriptors_match_jax_defaults():
    from common_tpu import models as jmodels

    pairs = [(models.bb, jmodels.bb), (models.bbnc, jmodels.bbnc), (models.gp, jmodels.gp),
             (models.nich, jmodels.nich), (models.bnb, jmodels.bnb),
             (models.dd(4), jmodels.dd(4)), (models.dm(3), jmodels.dm(3)),
             (models.niw(3), jmodels.niw(3)), (models.bbv(5), jmodels.bbv(5))]
    for t, j in pairs:
        assert t.name == j.name
        assert (t.rtype.dtype, t.rtype.shape) == (j.rtype.dtype, j.rtype.shape), t.name
        assert set(t.default_hyper) == set(j.default_hyper), t.name
        for k, v in j.default_hyper.items():
            np.testing.assert_array_equal(np.asarray(t.default_hyper[k]), np.asarray(v))
        th = t.canonical_hyper(device="cpu")
        assert all(v.dtype == torch.float32 for v in th.values()), t.name
    with pytest.raises(ValueError):
        models.dd(0)
    with pytest.raises(ValueError):
        models.dm(0)
    assert tlik.names() == jlik.names()
