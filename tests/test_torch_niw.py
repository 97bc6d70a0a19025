"""NIW likelihood: the PyTorch port against the JAX package, in float64.

The same numpy inputs go through `common_tpu.likelihoods.niw` (under
`jax.enable_x64`) and `common_tpu_torch.likelihoods.niw`; deterministic
functions agree to rtol = atol = 1e-9. The port's posterior draws are held
to their analytic mean.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import multigammaln

from common_tpu.likelihoods import niw as jniw
from common_tpu_torch.likelihoods import niw as tniw
from common_tpu_torch.likelihoods.niw import multigammaln as t_multigammaln

torch.set_num_threads(2)

TOL = dict(rtol=1e-9, atol=1e-9)
D, K, N = 3, 5, 60


def _problem(seed=0):
    """Hypers, rows, mask and assignments (slot K-1 stays empty), float64."""
    r = np.random.default_rng(seed)
    a = r.normal(size=(D, D))
    hyper = {
        "mu0": r.normal(size=D),
        "kappa": np.float64(0.7),
        "psi": a @ a.T + D * np.eye(D),
        "nu": np.float64(D + 1.5),
    }
    X = r.normal(scale=2.0, size=(N, D))
    mask = (r.random(N) > 0.2).astype(np.float64)
    gid = r.integers(0, K, N).astype(np.int32)
    gid[gid == K - 1] = K  # dropped: slot K-1 stays empty
    return hyper, X, mask, gid


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _stats_np(hyper, X, mask, gid):
    with jax.enable_x64(True):
        return _np(jniw.stats_from_assignments(_jax(hyper), jnp.asarray(X),
                                               jnp.asarray(mask), jnp.asarray(gid), K))


def test_stats_from_assignments_matches_jax():
    hyper, X, mask, gid = _problem()
    want = _stats_np(hyper, X, mask, gid)
    got = tniw.stats_from_assignments(_torch(hyper), torch.from_numpy(X),
                                      torch.from_numpy(mask), torch.from_numpy(gid), K)
    assert want["sum_xxT"].dtype == np.float64
    for leaf in ("n", "sum_x", "sum_xxT"):
        np.testing.assert_allclose(got[leaf].numpy(), want[leaf], err_msg=leaf, **TOL)
    assert float(got["n"][K - 1]) == 0.0


def test_tx_and_init_stats_match_jax():
    hyper, X, mask, _ = _problem(6)
    with jax.enable_x64(True):
        want_tx = _np(jniw.tx(_jax(hyper), jnp.asarray(X[3]), jnp.asarray(0.0)))
        want_tx1 = _np(jniw.tx(_jax(hyper), jnp.asarray(X[3]), jnp.asarray(1.0)))
        want_zero = _np(jniw.init_stats(_jax(hyper), (K,)))
    got_tx = tniw.tx(_torch(hyper), torch.from_numpy(X[3]), 0.0)
    got_tx1 = tniw.tx(_torch(hyper), torch.from_numpy(X[3]), 1.0)
    got_zero = tniw.init_stats(_torch(hyper), (K,))
    for leaf in ("n", "sum_x", "sum_xxT"):
        np.testing.assert_allclose(got_tx[leaf].numpy(), want_tx[leaf], **TOL)
        np.testing.assert_allclose(got_tx1[leaf].numpy(), want_tx1[leaf], **TOL)
        assert got_zero[leaf].shape == want_zero[leaf].shape
        assert got_zero[leaf].dtype == torch.float64 and not got_zero[leaf].any()


def test_posterior_hyper_matches_jax():
    hyper, X, mask, gid = _problem(1)
    stats = _stats_np(hyper, X, mask, gid)
    with jax.enable_x64(True):
        want = _np(jniw.posterior_hyper(_jax(hyper), _jax(stats)))
    got = tniw.posterior_hyper(_torch(hyper), _torch(stats))
    for leaf in ("mu0", "kappa", "psi", "nu"):
        np.testing.assert_allclose(got[leaf].numpy(), want[leaf], err_msg=leaf, **TOL)


def test_marginal_loglik_matches_jax_and_is_zero_when_empty():
    hyper, X, mask, gid = _problem(2)
    stats = _stats_np(hyper, X, mask, gid)
    with jax.enable_x64(True):
        want = np.asarray(jniw.marginal_loglik(_jax(hyper), _jax(stats)))
    got = tniw.marginal_loglik(_torch(hyper), _torch(stats)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert got[K - 1] == 0.0 and want[K - 1] == 0.0


def test_pred_logpdf_matches_jax():
    hyper, X, mask, gid = _problem(3)
    stats = _stats_np(hyper, X, mask, gid)
    x = np.random.default_rng(9).normal(size=D)
    with jax.enable_x64(True):
        want = np.asarray(jniw.pred_logpdf(_jax(hyper), _jax(stats), jnp.asarray(x)))
    got = tniw.pred_logpdf(_torch(hyper), _torch(stats), torch.from_numpy(x)).numpy()
    assert got.shape == (K,)
    np.testing.assert_allclose(got, want, **TOL)
    # many rows at once, from one factorization
    rows = np.random.default_rng(10).normal(size=(7, D))
    pred = tniw.predictive(_torch(hyper), _torch(stats))
    many = tniw.predictive_logpdf(pred, torch.from_numpy(rows)).numpy()
    with jax.enable_x64(True):
        for i in range(7):
            np.testing.assert_allclose(
                many[i], np.asarray(jniw.pred_logpdf(_jax(hyper), _jax(stats),
                                                     jnp.asarray(rows[i]))), **TOL)


def test_logpdf_batch_matches_jax_on_the_same_theta():
    hyper, X, mask, gid = _problem(4)
    stats = _stats_np(hyper, X, mask, gid)
    with jax.enable_x64(True):
        theta = _np(jniw.sample_params(jax.random.key(0), _jax(hyper), _jax(stats)))
        want = np.asarray(jniw.logpdf_batch(_jax(theta), jnp.asarray(X), jnp.asarray(mask)))
    got = tniw.logpdf_batch(_torch(theta), torch.from_numpy(X), torch.from_numpy(mask)).numpy()
    assert got.shape == (N, K)
    np.testing.assert_allclose(got, want, **TOL)


def test_sample_params_mean_matches_posterior():
    """E[Sigma] = psi_n / (nu_n - d - 1) and E[mu] = mu_n, within 5 MC s.e."""
    hyper, X, mask, gid = _problem(5)
    stats = _stats_np(hyper, X, mask, gid)
    one = {k: v[0] for k, v in stats.items()}  # cluster 0
    S = 4000
    batch = {k: torch.as_tensor(np.broadcast_to(v, (S, *v.shape)).copy()) for k, v in one.items()}
    g = torch.Generator().manual_seed(0)
    theta = tniw.sample_params(g, _torch(hyper), batch)
    chol = theta["cov_chol"]
    sigma = (chol @ chol.transpose(-1, -2)).numpy()
    post = tniw.posterior_hyper(_torch(hyper), _torch(one))
    psi_n, nu_n = post["psi"].numpy(), float(post["nu"])
    assert nu_n > D + 3  # finite variance of Sigma's entries
    want = psi_n / (nu_n - D - 1)
    se = sigma.std(0) / np.sqrt(S)
    assert np.all(np.abs(sigma.mean(0) - want) < 5 * se), (sigma.mean(0), want, se)
    mu = theta["mu"].numpy()
    se_mu = mu.std(0) / np.sqrt(S)
    assert np.all(np.abs(mu.mean(0) - post["mu0"].numpy()) < 5 * se_mu)
    # every factor is lower triangular with a positive diagonal
    assert torch.equal(chol, torch.tril(chol))
    assert bool((torch.diagonal(chol, dim1=-2, dim2=-1) > 0).all())


@pytest.mark.parametrize("n_rows", [0, 1, 40])
def test_multigammaln_matches_jax(n_rows):
    a = np.float64(D + 1.5 + n_rows) / 2.0
    with jax.enable_x64(True):
        want = float(multigammaln(jnp.asarray(a), D))
    got = float(t_multigammaln(torch.tensor(a, dtype=torch.float64), D))
    np.testing.assert_allclose(got, want, **TOL)
