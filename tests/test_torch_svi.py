"""The port's stochastic VI (`kernels/svi.py`) against the JAX package.

CAVI is deterministic, so one variational posterior, made by the JAX
package's `svi.init` under `jax.enable_x64` and carried across as numpy
leaves (`convert.svi_from_numpy`), goes through both packages:
`responsibilities`, `update` (a natural-gradient blend, rho < 1),
`elbo` and 5 steps of `fit_cavi` agree element by element to rtol = atol
= 1e-6. The JAX package casts rows to float32 inside bb's and gp's
`suffstat_pair` and `log_h` (gp's log-gamma of the row, niw's float32
mask times log 2 pi), so rows are float32-exact and those float32 terms
set the tolerance; the rest is float64 on both sides.

The behaviour tests of tests/test_svi.py follow in the port, in float64:
the ELBO never falls under CAVI (niw, bb, bbv), planted clusters are
recovered, fixed-K mode, the refusal of bnb and bbnc, `to_state`,
`predictive_logpdf`, and minibatch SVI converging near the CAVI optimum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common_tpu import models as jmodels
from common_tpu import state as jst
from common_tpu.kernels import svi as jsvi
from common_tpu_torch import convert, models, rng
from common_tpu_torch import state as st
from common_tpu_torch.kernels import svi

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)
# gp's sum of log x! is a float32 log-gamma of the row in the JAX package
# (rtol 2.5e-7 after one CAVI step, 2.3e-6 after five): rtol 1e-5 there
F32_LEAVES = {"sum_log_fact": dict(rtol=1e-5, atol=1e-6)}


def _gen(seed):
    return rng(seed, "cpu").generator


def _close(got, want, msg="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


def _jleaves(post):
    """A JAX SVIPosterior's numpy leaves (the layout of `convert.svi_to_numpy`)."""
    arrays = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return {"stick_a": np.asarray(post.stick_a), "stick_b": np.asarray(post.stick_b),
            "dir_conc": np.asarray(post.dir_conc), "vstats": tuple(arrays(v) for v in post.vstats),
            "hypers": tuple(arrays(h) for h in post.hypers), "cluster_hp": arrays(post.cluster_hp),
            "lik_names": tuple(post.lik_names), "fixed": bool(post.fixed)}


def _jpost(leaves):
    arr = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    return jsvi.SVIPosterior(
        stick_a=jnp.asarray(leaves["stick_a"]), stick_b=jnp.asarray(leaves["stick_b"]),
        dir_conc=jnp.asarray(leaves["dir_conc"]), vstats=tuple(arr(v) for v in leaves["vstats"]),
        hypers=tuple(arr(h) for h in leaves["hypers"]), cluster_hp=arr(leaves["cluster_hp"]),
        lik_names=tuple(leaves["lik_names"]), fixed=leaves["fixed"])


def _columns(kind, n, seed):
    """(numpy columns, port descriptors, JAX descriptors, feature hypers)."""
    r = np.random.default_rng(seed)
    z = r.integers(0, 3, n)
    X = np.round((np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])[z]
                  + r.normal(scale=0.8, size=(n, 2))) * 16) / 16
    niw_h = {"mu0": np.zeros(2), "kappa": 0.5, "psi": np.eye(2), "nu": 4.0}
    if kind == "niw":
        return [X], [models.niw(2)], [jmodels.niw(2)], [niw_h]
    cols = [X, r.poisson(np.array([0.5, 3.0, 8.0])[z]).astype(np.float64),
            (r.random(n) < np.array([0.1, 0.5, 0.9])[z]).astype(np.float64)]
    return (cols, [models.niw(2), models.gp, models.bb], [jmodels.niw(2), jmodels.gp, jmodels.bb],
            [niw_h, {"alpha": 1.5, "inv_beta": 0.7}, {"alpha": 0.8, "beta": 1.2}])


def _shared(kind, fixed=False, n=90, k_max=6, seed=0):
    """One posterior from the JAX package's init, in both packages, with the data."""
    cols, _, jdescs, hps = _columns(kind, n, seed)
    mask = (np.random.default_rng(seed + 1).random(n) > 0.1).astype(np.float64)
    chp = {"alphas": np.linspace(0.5, 2.0, k_max)} if fixed else {"alpha": 1.3}
    with jax.enable_x64(True):
        jdata = tuple((jnp.asarray(c), jnp.asarray(mask)) for c in cols)
        jpost = jsvi.init(jst.model_definition(n, jdescs, k_max=k_max), jdata, jax.random.key(seed),
                          cluster_hp=chp, feature_hps=hps, fixed=fixed)
        leaves = _jleaves(jpost)
    data = tuple((torch.from_numpy(c), torch.from_numpy(mask)) for c in cols)
    return leaves, jdata, convert.svi_from_numpy(leaves, device="cpu"), data


def _assert_post_close(got, want_leaves):
    back = convert.svi_to_numpy(got)
    for k in ("stick_a", "stick_b", "dir_conc"):
        _close(back[k], want_leaves[k], k)
    for f, (a, b) in enumerate(zip(back["vstats"], want_leaves["vstats"])):
        assert set(a) == set(b)
        for leaf in b:
            _close(a[leaf], b[leaf], f"{f}.{leaf}", F32_LEAVES.get(leaf, TOL))


CASES = [("niw", False), ("mixed", False), ("mixed", True)]


@pytest.mark.parametrize("kind,fixed", CASES)
def test_responsibilities_update_and_elbo_match_jax(kind, fixed):
    leaves, jdata, post, data = _shared(kind, fixed)
    r, logp = svi.responsibilities(post, data)
    r_np = r.numpy()
    with jax.enable_x64(True):
        jpost = _jpost(leaves)
        jr, jlogp = jsvi.responsibilities(jpost, jdata)
        jw = np.asarray(jsvi.expected_log_weights(jpost))
        jup = _jleaves(jsvi.update(jpost, jdata, jnp.asarray(r_np), rho=0.7, scale=1.3))
        jelbo = float(jsvi.elbo(jpost, jdata))
    _close(svi.expected_log_weights(post), jw)
    _close(logp, jlogp)
    _close(r, jr)
    _assert_post_close(svi.update(post, data, r, rho=0.7, scale=1.3), jup)
    _close(svi.elbo(post, data), jelbo)


@pytest.mark.parametrize("kind,fixed", CASES)
def test_five_cavi_steps_match_jax(kind, fixed):
    leaves, jdata, post, data = _shared(kind, fixed, seed=2)
    out, elbos = svi.fit_cavi(post, data, 5)
    with jax.enable_x64(True):
        jout, jelbos = jsvi.fit_cavi(_jpost(leaves), jdata, 5)
        jleaves, jelbos = _jleaves(jout), np.asarray(jelbos)
    assert elbos.shape == (5,)
    _close(elbos, jelbos)
    _assert_post_close(out, jleaves)


def test_the_posterior_round_trips_through_numpy():
    leaves, _, post, _ = _shared("mixed")
    back = convert.svi_to_numpy(post)
    for k in ("stick_a", "stick_b", "dir_conc"):
        np.testing.assert_array_equal(back[k], leaves[k])
        assert back[k].dtype == leaves[k].dtype
    for a, b in zip(back["vstats"] + back["hypers"], leaves["vstats"] + leaves["hypers"]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert back["lik_names"] == ("niw", "gp", "bb") and back["fixed"] is False


# ---------------------------------------------------------------------------
# behaviour (tests/test_svi.py in the port, float64)
# ---------------------------------------------------------------------------
def _gaussian_problem(n=600, d=2, seed=0, k_max=12):
    r = np.random.default_rng(seed)
    z = r.integers(0, 3, n)
    X = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])[:, :d][z] + r.normal(scale=0.6, size=(n, d))
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    return defn, ((torch.from_numpy(X), torch.ones(n, dtype=torch.float64)),), z


def _agreement(zz, z):
    return ((zz[:, None] == zz[None, :]) == (z[:, None] == z[None, :])).mean()


def _assert_monotone(elbos):
    """The CAVI guarantee in float64: no step falls by more than 1e-10 of |ELBO|."""
    e = elbos.numpy()
    assert np.isfinite(e).all()
    assert (np.diff(e) >= -1e-10 * np.abs(e[1:])).all(), np.diff(e)


def test_cavi_elbo_monotone_and_recovers():
    defn, data, z = _gaussian_problem()
    post = svi.init(defn, data, _gen(0), cluster_hp={"alpha": 1.0})
    post, elbos = svi.fit_cavi(post, data, 60)
    _assert_monotone(elbos)
    hard = svi.to_state(post, data)
    assert _agreement(hard.assignments.numpy(), z) > 0.95
    # to_state is a consistent MixtureState: counts a bincount, stats a restat
    assert torch.equal(hard.counts, st._assignment_counts(hard.assignments, 12))
    ref = st.compute_stats(defn, hard.hypers, data, hard.assignments)
    for k, v in ref[0].items():
        torch.testing.assert_close(hard.stats[0][k], v, rtol=1e-12, atol=1e-12)
    assert np.isfinite(float(st.score_joint(hard)))


def test_cavi_bb_elbo_monotone():
    n = 300
    r = np.random.default_rng(1)
    z = r.integers(0, 2, n)
    x = (r.random(n) < np.where(z == 0, 0.9, 0.1)).astype(np.float64)
    defn = st.model_definition(n, [models.bb], k_max=8)
    data = ((torch.from_numpy(x), torch.ones(n, dtype=torch.float64)),)
    post = svi.init(defn, data, _gen(2), cluster_hp={"alpha": 1.0})
    _, elbos = svi.fit_cavi(post, data, 40)
    _assert_monotone(elbos)


def test_cavi_bbv_elbo_monotone_and_recovers():
    n, d = 400, 8
    r = np.random.default_rng(4)
    z = r.integers(0, 2, n)
    probs = np.where(r.uniform(size=(2, d)) < 0.5, 0.1, 0.9)
    x = (r.uniform(size=(n, d)) < probs[z]).astype(np.float64)
    defn = st.model_definition(n, [models.bbv(d)], k_max=6)
    data = ((torch.from_numpy(x), torch.ones(n, dtype=torch.float64)),)
    # CAVI finds a local optimum: keep the best ELBO of three inits, as a
    # user would (each run's ELBO is monotone)
    fits = []
    for seed in (2, 3, 4):
        post = svi.init(defn, data, _gen(seed), cluster_hp={"alpha": 1.0})
        post, elbos = svi.fit_cavi(post, data, 40)
        _assert_monotone(elbos)
        fits.append((float(elbos[-1]), seed, post))
    best = max(fits, key=lambda f: f[0])[2]
    assert _agreement(svi.to_state(best, data).assignments.numpy(), z) > 0.9


def test_fixed_k_dirichlet_mode():
    defn, data, _ = _gaussian_problem(k_max=3)
    post = svi.init(defn, data, _gen(3), cluster_hp={"alphas": np.ones(3)}, fixed=True)
    post, elbos = svi.fit_cavi(post, data, 50)
    _assert_monotone(elbos)
    hard = svi.to_state(post, data)
    assert int(hard.ngroups()) == 3 and hard.fixed and "alphas" in hard.cluster_hp


def test_minibatch_svi_converges():
    """Minibatch SVI lands within 0.25 nats a row of the CAVI optimum and
    recovers the planted clusters (tests/test_svi.py:166-187, its sizes,
    1000 steps: at 400, both packages stop short of the optimum from some
    inits; the JAX test's keys land within the bar, seeds 7-11 of either
    package do not)."""
    defn, data, z = _gaussian_problem(n=5000, seed=4)
    ref = svi.init(defn, data, _gen(5), cluster_hp={"alpha": 1.0})
    ref, _ = svi.fit_cavi(ref, data, 40)
    post = svi.init(defn, data, _gen(6), cluster_hp={"alpha": 1.0})
    init_elbo = float(svi.elbo(post, data))
    g = _gen(7)
    post, rhos = svi.fit_svi(post, data, g, 1000, batch_size=512)
    assert rhos.shape == (1000,) and float(rhos[0]) == pytest.approx(10.0 ** -0.7)
    elbo_svi = float(svi.elbo(post, data))
    assert elbo_svi > init_elbo
    assert (float(svi.elbo(ref, data)) - elbo_svi) / defn.n < 0.25
    assert _agreement(svi.to_state(post, data).assignments.numpy(), z) > 0.9


def test_fit_svi_steps_match_jax_on_the_same_batches():
    """fit_svi's minibatch steps, replayed in the JAX package on the batches
    the port drew (the generator's `randint` sequence), give the same
    posterior: rtol = atol = 1e-6 (sum_log_fact 1e-5)."""
    leaves, jdata, post, data = _shared("mixed", seed=4)
    n, batch, steps = 90, 32, 6
    out, rhos = svi.fit_svi(post, data, _gen(11), steps, batch_size=batch)
    replay = _gen(11)
    with jax.enable_x64(True):
        jp = _jpost(leaves)
        for t in range(steps):
            idx = torch.randint(0, n, (batch,), generator=replay).numpy()
            b = tuple((x[idx], m[idx]) for x, m in jdata)
            r, _ = jsvi.responsibilities(jp, b)
            jp = jsvi.update(jp, b, r, rho=(t + 10.0) ** -0.7, scale=n / batch)
        jl = _jleaves(jp)
    _close(rhos, (np.arange(steps) + 10.0) ** -0.7)
    _assert_post_close(out, jl)


@pytest.mark.parametrize("desc", [models.bbnc, models.bnb], ids=lambda d: d.name)
def test_svi_rejects_nonexpfam(desc):
    defn = st.model_definition(4, [desc], k_max=2)
    data = ((torch.zeros(4), torch.ones(4)),)
    with pytest.raises(ValueError, match="exponential-family"):
        svi.init(defn, data, _gen(0))


def test_predictive_logpdf_reasonable():
    defn, data, _ = _gaussian_problem()
    post = svi.init(defn, data, _gen(8), cluster_hp={"alpha": 1.0})
    post, _ = svi.fit_cavi(post, data, 40)
    near = svi.predictive_logpdf(post, ((torch.tensor([-4.0, 0.0], dtype=torch.float64), 1.0),))
    far = svi.predictive_logpdf(post, ((torch.tensor([50.0, 50.0], dtype=torch.float64), 1.0),))
    assert float(near) > float(far) + 10.0
    assert float(near) > -4.0


def test_predictive_logpdf_matches_jax():
    """The VB predictive of one row on a carried posterior, to 1e-6."""
    leaves, _, post, _ = _shared("mixed", seed=3)
    row = (np.array([3.9375, 0.25]), 4.0, 1.0)
    got = svi.predictive_logpdf(post, tuple((torch.tensor(v), 1.0) for v in row))
    with jax.enable_x64(True):
        want = float(jsvi.predictive_logpdf(_jpost(leaves), tuple((jnp.asarray(v), 1.0) for v in row)))
    _close(got, want)


def test_init_draws_on_the_callers_generator():
    """init is a function of the generator's state: the same seed gives the
    same posterior, another seed another."""
    defn, data, _ = _gaussian_problem(n=100)
    a = svi.init(defn, data, _gen(1))
    b = svi.init(defn, data, _gen(1))
    c = svi.init(defn, data, _gen(2))
    assert torch.equal(a.vstats[0]["sum_x"], b.vstats[0]["sum_x"])
    assert not torch.equal(a.vstats[0]["sum_x"], c.vstats[0]["sum_x"])
    assert dataclasses.replace(a).k_max == 12 and a.device == torch.device("cpu")
