"""The port's exponential-family layer against the JAX package, in float64.

For each of the seven likelihoods with `has_expfam` (bb, bbv, dd, dm, gp,
nich, niw) the same numpy hypers, rows, masks and soft weights go through
`common_tpu` (under `jax.enable_x64`) and `common_tpu_torch`:
`nat_params`, `log_partition` (batched over K slots), `expected_T`
(`expected_T_k` in JAX), `kl`, `kl_k`, `expected_loglik_table`,
`stats_from_weights`, `suffstat_pair` and `log_h`.

Tolerance: rtol = atol = 1e-6 throughout. The JAX package casts rows and
masks to float32 inside `suffstat_pair`, `log_h` and `tx` of every family
but niw, so rows here are float32-exact (integers, or multiples of 1/16 for
nich); its float32 `log_h` of gp (a log-gamma of the row) and of nich and
niw (a float32 mask times log 2 pi) still carries float32 rounding, which
the 1e-6 covers. The hyper-side functions agree to float64 rounding.
Also the analytic Beta and Gamma KL checks of tests/test_svi.py, and the
expected log density against Monte Carlo.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common_tpu import likelihoods as jlik
from common_tpu.likelihoods import expfam as jexp
from common_tpu_torch import likelihoods as tlik
from common_tpu_torch import rng
from common_tpu_torch.likelihoods import expfam

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)
K, N = 4, 30

# name -> (prior hyper, row generator, posterior pseudo-stats generator)
CASES = {
    "bb": ({"alpha": 1.3, "beta": 0.7}, lambda r, n: r.integers(0, 2, n).astype(np.float64)),
    "bbv": ({"alpha": np.array([0.5, 1.0, 1.5]), "beta": np.array([1.5, 0.7, 1.0])},
            lambda r, n: r.integers(0, 2, (n, 3)).astype(np.float64)),
    "dd": ({"alphas": np.array([0.5, 1.0, 2.0])}, lambda r, n: r.integers(0, 3, n)),
    "dm": ({"alphas": np.array([0.5, 1.0, 2.0])},
           lambda r, n: r.multinomial(5, [0.3, 0.3, 0.4], size=n).astype(np.float64)),
    "gp": ({"alpha": 2.0, "inv_beta": 1.5}, lambda r, n: r.poisson(3.0, n).astype(np.float64)),
    "nich": ({"mu": 0.3, "kappa": 1.2, "sigmasq": 0.8, "nu": 2.0},
             lambda r, n: np.round(r.normal(scale=2.0, size=n) * 16) / 16),
    "niw": ({"mu0": np.array([0.2, -0.4]), "kappa": 1.7,
             "psi": np.array([[1.2, 0.3], [0.3, 0.8]]), "nu": 3.5},
            lambda r, n: np.round(r.normal(scale=2.0, size=(n, 2)) * 16) / 16),
}
NAMES = list(CASES)


def _t(d):
    return {k: torch.tensor(np.asarray(v, np.float64)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **TOL)


def _problem(name, seed=0):
    """Prior hyper, rows, a mask, soft weights r [N, K] and the [K] posterior
    hypers q_k at the weighted pseudo-stats (from the port, in float64)."""
    hyper = {k: np.asarray(v, np.float64) for k, v in CASES[name][0].items()}
    r = np.random.default_rng(seed)
    X = CASES[name][1](r, N)
    mask = (r.random(N) > 0.2).astype(np.float64)
    w = r.dirichlet(np.ones(K), size=N)
    lik = tlik.get(name)
    stats = lik.stats_from_weights(_t(hyper), torch.tensor(X), torch.tensor(mask), torch.tensor(w))
    q = _np(lik.posterior_hyper(_t(hyper), stats))
    return hyper, X, mask, w, q


@pytest.mark.parametrize("name", NAMES)
def test_stats_from_weights_matches_jax(name):
    hyper, X, mask, w, _ = _problem(name)
    got = tlik.get(name).stats_from_weights(_t(hyper), torch.tensor(X), torch.tensor(mask),
                                            torch.tensor(w))
    with jax.enable_x64(True):
        want = _np(jlik.base.get(name).stats_from_weights(_j(hyper), jnp.asarray(X),
                                                          jnp.asarray(mask), jnp.asarray(w)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float64, k
        _close(got[k], want[k], k)


@pytest.mark.parametrize("name", NAMES)
def test_nat_params_and_log_partition_match_jax(name):
    """One hyper, and the [K] posterior hypers batched (JAX: a vmap)."""
    hyper, _, _, _, q = _problem(name, 1)
    tl, jl = tlik.get(name), jlik.base.get(name)
    with jax.enable_x64(True):
        want_nat = _np(jl.nat_params(_j(hyper)))
        want_a = float(jl.log_partition(jl.nat_params(_j(hyper))))
        want_nat_k = _np(jax.vmap(jl.nat_params)(_j(q)))
        want_a_k = np.asarray(jax.vmap(lambda h: jl.log_partition(jl.nat_params(h)))(_j(q)))
    got_nat = tl.nat_params(_t(hyper))
    got_nat_k = tl.nat_params(_t(q))
    assert set(got_nat) == set(want_nat)
    for k in want_nat:
        _close(got_nat[k], want_nat[k], k)
        _close(got_nat_k[k], want_nat_k[k], k)
    _close(tl.log_partition(got_nat), want_a)
    got_a_k = tl.log_partition(got_nat_k)
    assert got_a_k.shape == (K,)
    _close(got_a_k, want_a_k)


@pytest.mark.parametrize("name", NAMES)
def test_expected_T_matches_jax(name):
    """E_q[T] of all K slots as one gradient of sum_k A, against JAX's vmap."""
    hyper, _, _, _, q = _problem(name, 2)
    with jax.enable_x64(True):
        want_k = _np(jexp.expected_T_k(jlik.base.get(name), _j(q)))
        want = _np(jexp.expected_T(jlik.base.get(name), _j(hyper)))
    got_k = expfam.expected_T_k(tlik.get(name), _t(q))
    got = expfam.expected_T(tlik.get(name), _t(hyper))
    for k in want:
        assert got_k[k].shape == want_k[k].shape, k
        _close(got_k[k], want_k[k], k)
        _close(got[k], want[k], k)


@pytest.mark.parametrize("name", NAMES)
def test_kl_and_kl_k_match_jax(name):
    hyper, _, _, _, q = _problem(name, 3)
    jl, tl = jlik.base.get(name), tlik.get(name)
    q0 = {k: v[0] for k, v in q.items()}
    with jax.enable_x64(True):
        want_k = np.asarray(jexp.kl_k(jl, _j(q), _j(hyper)))
        want = float(jexp.kl(jl, _j(q0), _j(hyper)))
    got_k = expfam.kl_k(tl, _t(q), _t(hyper))
    assert got_k.shape == (K,)
    _close(got_k, want_k)
    _close(expfam.kl(tl, _t(q0), _t(hyper)), want)
    assert (got_k > 0).all()
    _close(expfam.kl(tl, _t(hyper), _t(hyper)), 0.0)


@pytest.mark.parametrize("name", NAMES)
def test_expected_loglik_table_matches_jax(name):
    hyper, X, mask, _, q = _problem(name, 4)
    jl, tl = jlik.base.get(name), tlik.get(name)
    with jax.enable_x64(True):
        want = np.asarray(jexp.expected_loglik_table(jl, _j(hyper), _j(q), jnp.asarray(X),
                                                     jnp.asarray(mask)))
        want_row = float(jexp.expected_logpdf(jl, {k: jnp.asarray(v[1]) for k, v in q.items()},
                                              jnp.asarray(X[2]), 1.0))
    got = expfam.expected_loglik_table(tl, _t(hyper), _t(q), torch.tensor(X), torch.tensor(mask))
    assert got.shape == (N, K)
    _close(got, want)
    _close(expfam.expected_logpdf(tl, {k: torch.tensor(v[1]) for k, v in q.items()},
                                  torch.tensor(X[2]), 1.0), want_row)
    # a masked row scores log_h = 0 against every slot
    assert (got[torch.tensor(mask) == 0] == 0).all()


@pytest.mark.parametrize("name", NAMES)
def test_suffstat_pair_and_log_h_match_jax(name):
    hyper, X, mask, _, _ = _problem(name, 5)
    jl, tl = jlik.base.get(name), tlik.get(name)
    with jax.enable_x64(True):
        want = _np(jax.vmap(lambda x, m: jl.suffstat_pair(_j(hyper), x, m))(jnp.asarray(X),
                                                                            jnp.asarray(mask)))
        want_h = np.asarray(jl.log_h(_j(hyper), jnp.asarray(X), jnp.asarray(mask)))
    got = tl.suffstat_pair(_t(hyper), torch.tensor(X), torch.tensor(mask))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    _close(tl.log_h(_t(hyper), torch.tensor(X), torch.tensor(mask)), want_h)


def test_expfam_kl_beta_analytic():
    """tests/test_svi.py:73-84 in the port: quadrature truth, to 1e-3."""
    from scipy.stats import beta as spb

    got = float(expfam.kl(tlik.get("bb"), _t({"alpha": 5.0, "beta": 2.0}),
                          _t({"alpha": 1.0, "beta": 1.0})))
    xs = np.linspace(1e-6, 1 - 1e-6, 200001)
    qd, pd = spb(5, 2).pdf(xs), spb(1, 1).pdf(xs)
    truth = np.trapezoid(qd * (np.log(qd) - np.log(pd)), xs)
    assert abs(got - truth) < 1e-3, (got, truth)


def test_expfam_kl_gamma_analytic():
    """tests/test_svi.py:87-98 in the port: the closed form, to 1e-4 (here
    float64, so to 1e-12)."""
    from scipy.special import digamma as dg, gammaln as gl

    got = float(expfam.kl(tlik.get("gp"), _t({"alpha": 6.0, "inv_beta": 3.0}),
                          _t({"alpha": 1.0, "inv_beta": 1.0})))
    a1, b1, a0, b0 = 6.0, 3.0, 1.0, 1.0
    truth = ((a1 - a0) * dg(a1) - gl(a1) + gl(a0)
             + a0 * (np.log(b1) - np.log(b0)) + a1 * (b0 - b1) / b1)
    assert abs(got - truth) < 1e-12, (got, truth)


@pytest.mark.parametrize("name,hyper_q,x", [
    ("bb", {"alpha": 3.0, "beta": 2.0}, 1.0),
    ("gp", {"alpha": 4.0, "inv_beta": 2.0}, 3.0),
    ("nich", {"mu": 0.5, "kappa": 2.0, "sigmasq": 1.5, "nu": 5.0}, 0.3),
    ("niw", {"mu0": np.zeros(2), "kappa": 2.0, "psi": np.eye(2) * 2.0, "nu": 6.0},
     np.array([0.4, -0.3])),
])
def test_expected_logpdf_matches_monte_carlo(name, hyper_q, x):
    """tests/test_svi.py:43-69 in the port: the autodiff expectation against
    the mean of log p(x | theta) over 40,000 draws theta ~ q (the port's
    sample_params at zero stats), to 3% of max(1, |exact|)."""
    lik = tlik.get(name)
    hq = _t(hyper_q)
    xt = torch.tensor(np.asarray(x, np.float64))
    exact = float(expfam.expected_logpdf(lik, hq, xt, 1.0))
    zero = lik.init_stats(hq, (40000,))
    thetas = lik.sample_params(rng(0, "cpu").generator, hq, zero)
    mc = float(lik.logpdf(thetas, xt).mean())
    assert abs(exact - mc) < 0.03 * max(1.0, abs(exact)), (name, exact, mc)


def test_expfam_is_declared_where_jax_declares_it():
    """bnb and bbnc keep has_expfam False, as in the JAX package."""
    for name in tlik.names():
        assert tlik.get(name).has_expfam == jlik.base.get(name).has_expfam, name
    assert set(NAMES) == {n for n in tlik.names() if tlik.get(n).has_expfam}
