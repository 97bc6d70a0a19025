"""The port's state and scores against the JAX package on one state.

A JAX `MixtureState` goes to the port through `convert.state_from_numpy`;
both packages then score it. float32 on both sides, rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common_tpu import models as jmodels
from common_tpu import state as jst
from common_tpu import testutil
from common_tpu.kernels import blocked as jblocked
from common_tpu_torch import convert, models, rng
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked

torch.set_num_threads(2)

N, D, K = 120, 3, 8
TOL = dict(rtol=1e-5, atol=1e-4)


def _leaves(s):
    """A JAX MixtureState's leaves as numpy arrays."""
    arrays = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return {
        "assignments": np.asarray(s.assignments),
        "counts": np.asarray(s.counts),
        "cluster_hp": arrays(s.cluster_hp),
        "stats": tuple(arrays(f) for f in s.stats),
        "hypers": tuple(arrays(h) for h in s.hypers),
        "lik_names": tuple(s.lik_names),
        "fixed": bool(s.fixed),
    }


def _problem(fixed=False, seed=0):
    r = np.random.default_rng(seed)
    X = (r.normal(scale=3.0, size=(4, D))[r.integers(0, 4, N)]
         + r.normal(size=(N, D))).astype(np.float32)
    mask = (r.random(N) > 0.15).astype(np.float32)
    z = r.integers(0, 5, N).astype(np.int32)  # slots 5.. stay empty
    z[:3] = -1  # unassigned rows
    hyper = {"mu0": r.normal(size=D).astype(np.float32), "kappa": 0.5,
             "psi": 2.0 * np.eye(D, dtype=np.float32), "nu": float(D + 2)}
    chp = ({"alphas": np.linspace(0.5, 2.0, K).astype(np.float32)} if fixed
           else {"alpha": 1.3})
    jdefn = jst.model_definition(N, [jmodels.niw(D)], k_max=K)
    jdata = ((jnp.asarray(X), jnp.asarray(mask)),)
    js = jst.initialize(jdefn, jdata, jax.random.key(0), cluster_hp=chp,
                        feature_hps=[hyper], assignment=jnp.asarray(z), fixed=fixed)
    data = ((torch.from_numpy(X), torch.from_numpy(mask)),)
    return js, jdata, data, hyper, chp, z


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **kw})


@pytest.mark.parametrize("fixed", [False, True])
def test_scores_match_jax(fixed):
    js, _, _, _, _, _ = _problem(fixed)
    s = convert.state_from_numpy(_leaves(js), device="cpu")
    _close(st.score_assignment(s), jst.score_assignment(js))
    _close(st.score_likelihood(s), jst.score_likelihood(js))
    _close(st.score_joint(s), jst.score_joint(js))
    _close(st.crp_prior_scores(s), jst.crp_prior_scores(js))
    assert bool(st.is_saturated(s)) == bool(jst.is_saturated(js))


def test_heldout_logp_matches_jax(monkeypatch):
    monkeypatch.setattr(st, "HELDOUT_BATCH", 16)  # 37 rows: three batches, the last ragged
    js, _, _, _, _, _ = _problem()
    s = convert.state_from_numpy(_leaves(js), device="cpu")
    r = np.random.default_rng(5)
    Xh = r.normal(scale=3.0, size=(37, D)).astype(np.float32)
    mh = np.ones(37, np.float32)
    mh[4] = 0.0  # a masked cell scores only the weights
    want = jst.heldout_logp(js, ((jnp.asarray(Xh), jnp.asarray(mh)),))
    got = st.heldout_logp(s, ((torch.from_numpy(Xh), torch.from_numpy(mh)),))
    assert got.shape == (37,)
    _close(got, want)


@pytest.mark.parametrize("name", ["bb", "bnb", "gp", "nich", "dd", "dm", "bbnc", "niw", "bbv"])
def test_heldout_logp_matches_jax_for_every_likelihood(name):
    """30 rows at K_max=8, 5 held out: niw and bbv score through their
    factored predictives, the other seven through the generic one on
    `pred_logpdf` (common_tpu/state.py:445-475 scores every likelihood so)."""
    from test_torch_likelihoods import CASES, _rows

    desc, hyper = CASES[name][0], CASES[name][1]
    jdesc = {"niw": jmodels.niw(2), "bbv": jmodels.bbv(4), "dd": jmodels.dd(3), "dm": jmodels.dm(3)}.get(
        name, getattr(jmodels, name))
    rows = _rows(name, 35, 11)
    if rows.dtype.kind == "f":
        rows = rows.astype(np.float32)
    X, Xh = rows[:30], rows[30:]
    z = np.random.default_rng(12).integers(0, 4, 30).astype(np.int32)
    js = jst.initialize(jst.model_definition(30, [jdesc], k_max=8), ((jnp.asarray(X), jnp.ones(30)),),
                        jax.random.key(0), cluster_hp={"alpha": 1.3}, feature_hps=[hyper],
                        assignment=jnp.asarray(z))
    want = jst.heldout_logp(js, ((jnp.asarray(Xh), jnp.ones(5)),))
    s = convert.state_from_numpy(_leaves(js), device="cpu")
    got = st.heldout_logp(s, ((torch.from_numpy(Xh), torch.ones(5)),))
    assert got.shape == (5,) and desc.name == name
    _close(got, want)


@pytest.mark.parametrize("name", ["bb", "bnb", "gp", "nich", "bbnc", "dd", "dm"])
def test_generic_predictive_scores_scalar_rows_in_one_call(name, monkeypatch):
    """3000 rows through the generic `predictive_logpdf`, against one state
    ([K] stats) and a stack of two ([2, K] stats, hypers [2, 1]): one
    `pred_logpdf` call for the five scalar likelihoods, one a row for dd
    and dm, and the values of scoring row by row."""
    from test_torch_likelihoods import CASES, _rows, _stats

    hyper = {k: np.asarray(v, np.float64) for k, v in CASES[name][1].items()}
    lik = CASES[name][0].likelihood
    X = torch.from_numpy(_rows(name, 3000, 4))
    r = np.random.default_rng(6)
    fit = _rows(name, 40, 5)
    one = [{k: torch.from_numpy(v) for k, v in _stats(name, hyper, fit, np.ones(40),
                                                    r.integers(0, 6, 40).astype(np.int32)).items()}
           for _ in range(2)]
    h = {k: torch.from_numpy(v) for k, v in hyper.items()}
    stack = {k: torch.stack([one[0][k], one[1][k]]) for k in one[0]}
    h2 = {k: torch.stack([v, v]).unsqueeze(1) for k, v in h.items()}
    pred_logpdf = lik.pred_logpdf
    calls = []
    monkeypatch.setattr(lik, "pred_logpdf", lambda *a: calls.append(1) or pred_logpdf(*a))
    for hh, s in ((h, one[0]), (h2, stack)):
        calls.clear()
        got = lik.predictive_logpdf(lik.predictive(hh, s), X)
        assert got.shape == (3000, *s["n"].shape)
        assert len(calls) == (3000 if name in ("dd", "dm") else 1)
        want = torch.stack([pred_logpdf(hh, s, x) for x in X])
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fixed", [False, True])
def test_initialize_and_compute_stats_match_jax(fixed):
    js, _, data, hyper, chp, z = _problem(fixed)
    defn = st.model_definition(N, [models.niw(D)], k_max=K)
    s = st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp=chp,
                      feature_hps=[hyper], assignment=z, fixed=fixed)
    want = _leaves(js)
    got = convert.state_to_numpy(s)
    np.testing.assert_array_equal(got["assignments"], want["assignments"])
    np.testing.assert_array_equal(got["counts"], want["counts"])
    for part in ("cluster_hp",):
        for k, v in want[part].items():
            _close(got[part][k], v)
    for k, v in want["hypers"][0].items():
        _close(got["hypers"][0][k], v)
        assert got["hypers"][0][k].dtype == v.dtype, k
    for k, v in want["stats"][0].items():
        _close(got["stats"][0][k], v)
    fresh = st.compute_stats(defn, s.hypers, data, torch.from_numpy(z))
    for k, v in want["stats"][0].items():
        _close(fresh[0][k], v)


def test_restat_given_jax_z_matches_jax():
    js, jdata, data, _, _, _ = _problem()
    s = convert.state_from_numpy(_leaves(js), device="cpu")
    z = np.random.default_rng(8).integers(0, K, N).astype(np.int32)
    want = jblocked.restat(js, jdata, jnp.asarray(z))
    got = blocked.restat(s, data, torch.from_numpy(z))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    for k in ("n", "sum_x", "sum_xxT"):
        _close(got.stats[0][k], want.stats[0][k])
    _close(st.score_joint(got), jst.score_joint(want))


@pytest.mark.parametrize("fixed", [False, True])
def test_state_round_trip_keeps_leaves(fixed):
    js, _, _, _, _, _ = _problem(fixed)
    leaves = _leaves(js)
    back = convert.state_to_numpy(convert.state_from_numpy(leaves, device="cpu"))
    assert back.keys() == leaves.keys()
    assert back["lik_names"] == leaves["lik_names"] and back["fixed"] == leaves["fixed"]
    pairs = [(back["assignments"], leaves["assignments"]), (back["counts"], leaves["counts"])]
    for part in ("cluster_hp",):
        pairs += [(back[part][k], v) for k, v in leaves[part].items()]
    for part in ("stats", "hypers"):
        for b, w in zip(back[part], leaves[part]):
            assert b.keys() == w.keys()
            pairs += [(b[k], v) for k, v in w.items()]
    for b, w in pairs:
        assert b.dtype == w.dtype and b.shape == w.shape
        np.testing.assert_array_equal(b, w)


def test_crp_assignment_follows_the_eppf():
    """The host-loop CRP draw matches the exact partition prior (n=4)."""
    n, alpha = 4, 1.5
    defn = st.model_definition(n, [models.niw(2)], k_max=8)
    data = ((torch.zeros(n, 2), torch.ones(n)),)

    def score(part):
        s = st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": alpha},
                          assignment=np.asarray(part, np.int32))
        return float(st.score_assignment(s))

    exact = dict(zip(*testutil.dist_on_all_clusterings(score, n)))
    g = rng(3, "cpu").generator

    def sample_fn(m):
        return [testutil.permutation_canonical(
            st.sample_crp_assignment(g, n, 8, alpha).numpy()) for _ in range(m)]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=4000, ntries=3, kl_tol=0.01)


def test_crp_assignment_respects_k_max():
    z = st.sample_crp_assignment(rng(1, "cpu").generator, 500, 3, 50.0)
    assert z.dtype == torch.int32 and z.shape == (500,)
    assert set(z.unique().tolist()) == {0, 1, 2}


def test_state_helpers():
    js, _, _, _, _, _ = _problem()
    s = convert.state_from_numpy(_leaves(js), device="cpu")
    assert s.n == N and s.k_max == K and s.nentities() == N
    np.testing.assert_array_equal(s.groups(), js.groups())
    np.testing.assert_array_equal(s.empty_groups(), js.empty_groups())
    assert int(s.ngroups()) == int(js.ngroups())
    full = dataclasses.replace(s, counts=torch.ones(K, dtype=torch.int32))
    assert bool(st.is_saturated(full))
