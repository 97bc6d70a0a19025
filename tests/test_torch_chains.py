"""The port's multi-chain sweep (path A) against the JAX package.

Deterministic pieces (the expanded-quadratic score table, the chain
kernel's plain scores, diagnostics, stacked-state scores) get the same
numpy inputs on both sides, float32, with the tolerance stated at each
assert. The sampler is held to the exact-enumeration oracle, as
`tests/test_blocked.py` holds the JAX one, on each of its three routes; on
the CPU the fused route runs the multi-chain kernel's plain version.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from common_tpu import models as jmodels
from common_tpu import state as jst
from common_tpu import testutil
from common_tpu.kernels import blocked as jblocked
from common_tpu.likelihoods import niw as jniw
from common_tpu.ops.gaussian_assign import fused_gaussian_assign_chains as j_chains
from common_tpu.utils import diagnostics as jdiag
from common_tpu_torch import convert, models, rng
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked
from common_tpu_torch.likelihoods import niw as tniw
from common_tpu_torch.ops import gaussian_assign as ga
from common_tpu_torch.parallel import stack_states, unstack_state, vmap_sweep
from common_tpu_torch.utils import diagnostics

from test_gibbs_exact import exact_partition_posterior

torch.set_num_threads(2)


def _chain_problem(n, d, K, C, seed):
    """Rows, and per-chain (mu, dense minv with a positive diagonal, log w)."""
    r = np.random.default_rng(seed)
    X = r.normal(scale=2.0, size=(n, d)).astype(np.float32)
    mu = r.normal(scale=2.0, size=(C, K, d)).astype(np.float32)
    minv = (r.normal(scale=0.3, size=(C, K, d, d))
            + np.eye(d) * r.uniform(0.6, 1.4, size=(C, K, 1, d))).astype(np.float32)
    logw = np.log(r.dirichlet(np.ones(K), size=C)).astype(np.float32)
    m64 = minv.astype(np.float64)
    prec = (np.swapaxes(m64, -1, -2) @ m64).astype(np.float32)
    logdet = (-2.0 * np.log(np.abs(np.linalg.det(m64)))).astype(np.float32)  # log|Sigma|
    return X, mu, minv, prec, logdet, logw


def test_chain_score_table_matches_jax():
    X, mu, _, prec, logdet, logw = _chain_problem(300, 4, 8, 3, 0)
    want = np.asarray(jblocked._chain_score_table(*map(jnp.asarray, (mu, prec, logdet, logw, X))))
    got = blocked._chain_score_table(*map(torch.from_numpy, (mu, prec, logdet, logw, X))).numpy()
    assert got.shape == (300, 3, 8)
    # fp32 on both sides; the expanded form cancels, hence the atol
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_chain_plain_scores_via_minv_match_jax_table():
    """The multi-chain kernel's plain scores (||minv (x - mu)||^2 per chain's
    slots) equal JAX's expanded table built from prec = minv^T minv."""
    n, d, K, C = 300, 4, 8, 3
    X, mu, minv, prec, logdet, logw = _chain_problem(n, d, K, C, 1)
    want = np.asarray(jblocked._chain_score_table(*map(jnp.asarray, (mu, prec, logdet, logw, X))))
    base = (logw - 0.5 * logdet - 0.5 * d * np.log(2 * np.pi)).reshape(C * K).astype(np.float32)
    t = [torch.from_numpy(a) for a in (X, mu.reshape(C * K, d), minv.reshape(C * K, d, d), base)]
    got = ga.gaussian_scores(*t).reshape(n, C, K).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_chain_argmax_matches_pallas_interpret():
    """The interpreter's PRNG returns constant bits, so the Pallas chains
    kernel is a per-chain argmax of the scores there; the port's plain
    scores take the same argmax outside fp32 near-ties (rel 1e-4)."""
    n, d, K, C = 1500, 8, 16, 3
    X, mu, minv, _, logdet, logw = _chain_problem(n, d, K, C, 2)
    base = (logw - 0.5 * logdet).reshape(C * K).astype(np.float32)
    args = (X, mu.reshape(C * K, d), minv.reshape(C * K, d, d), base)
    with pltpu.force_tpu_interpret_mode():
        zj = np.asarray(j_chains(*map(jnp.asarray, args), 7, C, k_tile=8))
    s = ga.gaussian_scores(*map(torch.from_numpy, args)).reshape(n, C, K).numpy()
    zt = s.argmax(-1).T
    assert zj.shape == zt.shape == (C, n)
    for c in range(C):
        rows = np.arange(n)
        diff = zj[c] != zt[c]
        assert diff.mean() <= 1e-3, diff.mean()
        gap = np.abs(s[rows, c, zj[c]] - s[rows, c, zt[c]])
        assert np.all(gap[diff] <= 1e-4 * np.abs(s[rows, c, zt[c]][diff]))


def test_chains_wrapper_dominance_mapping_and_plain_seeding():
    """A dominant base logit per chain wins everywhere and chains' slot
    ranges do not leak; on the CPU the wrapper is the plain version seeded
    with `seed`, and counts no launch."""
    r = np.random.default_rng(0)
    n, d, K, C = 1500, 8, 16, 3
    X = torch.tensor(r.normal(size=(n, d)), dtype=torch.float32)
    mu = torch.zeros(C * K, d)
    binv = torch.eye(d).expand(C * K, d, d).contiguous()
    base = torch.zeros(C * K)
    targets = [3, 9, 14]
    for c, t in enumerate(targets):
        base[c * K + t] = 1000.0
    seed = torch.tensor([7], dtype=torch.int32)
    before = ga.fused_gaussian_assign_chains.launches
    z = ga.fused_gaussian_assign_chains(X, mu, binv, base, seed, C)
    assert z.shape == (C, n) and z.dtype == torch.int32
    for c, t in enumerate(targets):
        assert (z[c] == t).all()
    mu2 = torch.tensor(r.normal(size=(C * K, d)), dtype=torch.float32)
    base2 = torch.tensor(r.normal(size=C * K), dtype=torch.float32)
    z2 = ga.fused_gaussian_assign_chains(X, mu2, binv, base2, seed, C)
    assert int(z2.min()) >= 0 and int(z2.max()) < K
    want = ga.gaussian_assign_chains_plain(X, mu2, binv, base2, C, torch.Generator().manual_seed(7))
    assert torch.equal(z2, want)
    assert ga.fused_gaussian_assign_chains.launches == before
    with pytest.raises(ValueError, match="n_chains"):
        ga.fused_gaussian_assign_chains(X, mu2, binv, base2, seed, 5)
    meta = [t.to("meta") for t in (X, mu2, binv, base2)]
    with pytest.raises(ValueError, match="no kernel"):
        ga.fused_gaussian_assign_chains(*meta, seed.to("meta"), C)


def test_philox_gumbel_chain_word():
    """Chain 0 is the single-chain stream (counter (row, k, 0, 0)); other
    chains draw other numbers."""
    seed = torch.tensor([5], dtype=torch.int32)
    rows = torch.arange(2000)
    base = ga.philox_gumbel(seed, rows, 8)
    torch.testing.assert_close(ga.philox_gumbel(seed, rows, 8, chain=0), base, rtol=0, atol=0)
    others = [ga.philox_gumbel(seed, rows, 8, chain=c) for c in (1, 2)]
    for o in others:
        assert (o != base).float().mean() > 0.99
    assert (others[0] != others[1]).float().mean() > 0.99
    # the Gaussian check sees chain c's stream through philox_scores(chain=c)
    X = torch.randn(2000, 3)
    mu, binv, b = torch.zeros(8, 3), torch.eye(3).expand(8, 3, 3), torch.zeros(8)
    v = ga.philox_scores(X, mu, binv, b, seed, chain=2) - ga.gaussian_scores(X, mu, binv, b)
    torch.testing.assert_close(v, others[1], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# sample_params_prec
# ---------------------------------------------------------------------------
def _stacked(defn, data, C, seed, alpha=1.0):
    g = rng(seed, "cpu").generator
    return stack_states([st.initialize(defn, data, g, cluster_hp={"alpha": alpha})
                         for _ in range(C)])


def test_sample_params_prec_is_the_sample_params_draw():
    """One generator state: the same mu, prec inverts Sigma, logdet agrees
    (tests/test_blocked.py:225-259), batched over [C, K] with per-chain hypers."""
    r = np.random.default_rng(0)
    n, d, K, C = 300, 4, 8, 3
    X = torch.tensor(r.normal(scale=3.0, size=(n, d)), dtype=torch.float32)
    defn = st.model_definition(n, [models.niw(d)], k_max=K)
    states = _stacked(defn, ((X, torch.ones(n)),), C, 0)
    hyper = {k: v.unsqueeze(1) for k, v in states.hypers[0].items()}
    g = rng(7, "cpu").generator
    state0 = g.get_state()
    th = tniw.sample_params(g, hyper, states.stats[0])
    g.set_state(state0)
    tp = tniw.sample_params_prec(g, hyper, states.stats[0])
    assert tp["mu"].shape == (C, K, d) and tp["prec"].shape == (C, K, d, d)
    np.testing.assert_allclose(tp["mu"].numpy(), th["mu"].numpy(), rtol=1e-4, atol=1e-4)
    chol = th["cov_chol"].double().numpy()
    sigma = chol @ np.swapaxes(chol, -1, -2)
    np.testing.assert_allclose(tp["prec"].double().numpy() @ sigma,
                               np.broadcast_to(np.eye(d), sigma.shape), atol=5e-3)
    np.testing.assert_allclose(tp["logdet"].numpy(),
                               2.0 * np.log(np.diagonal(chol, axis1=-2, axis2=-1)).sum(-1),
                               rtol=1e-4, atol=1e-4)
    m = tp["minv"].double().numpy()
    np.testing.assert_allclose(np.swapaxes(m, -1, -2) @ m, tp["prec"].double().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_posterior_hyper_with_chain_hypers_matches_jax_per_chain():
    """Hypers [C, 1, ...] broadcast against stats [C, K, ...] give each
    chain's JAX posterior (rtol 1e-5)."""
    r = np.random.default_rng(3)
    C, K, d = 2, 5, 3
    a = r.normal(size=(C, d, d))
    hyp = {"mu0": r.normal(size=(C, d)), "kappa": r.uniform(0.5, 2, C),
           "psi": a @ np.swapaxes(a, -1, -2) + d * np.eye(d), "nu": d + r.uniform(1, 3, C)}
    X = r.normal(size=(40, d))
    gid = r.integers(0, K, 40).astype(np.int32)
    stats = {k: np.stack([np.asarray(v)] * C) for k, v in jniw.stats_from_assignments(
        {k: jnp.asarray(v[0], jnp.float32) for k, v in hyp.items()},
        jnp.asarray(X, jnp.float32), jnp.ones(40), jnp.asarray(gid), K).items()}
    hyp = {k: np.asarray(v, np.float32) for k, v in hyp.items()}
    got = tniw.posterior_hyper({k: torch.from_numpy(v).unsqueeze(1) for k, v in hyp.items()},
                               {k: torch.from_numpy(v) for k, v in stats.items()})
    for c in range(C):
        want = jniw.posterior_hyper({k: jnp.asarray(v[c]) for k, v in hyp.items()},
                                    {k: jnp.asarray(v[c]) for k, v in stats.items()})
        for leaf in want:
            np.testing.assert_allclose(got[leaf][c].numpy(), np.asarray(want[leaf]),
                                       rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# sweep_chains
# ---------------------------------------------------------------------------
ROUTES = {
    "wide": {},
    "fused": {"fused": True},
    "fallback": {"d_max_xx": 0},
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sweep_chains_matches_enumeration(route):
    """Each chain is a correct blocked-Gibbs sampler: pooled chain samples
    match the exact partition posterior (kl_tol 0.03), on every route."""
    r = np.random.default_rng(2)
    n, C = 4, 4
    X = r.normal(size=(n, 2)).astype(np.float32)
    chp = {"alpha": 1.5}
    exact = exact_partition_posterior(
        jst.model_definition(n, [jmodels.niw(2)], k_max=5),
        ((jnp.asarray(X), jnp.ones(n)),), chp,
    )
    defn = st.model_definition(n, [models.niw(2)], k_max=16)
    data = ((torch.from_numpy(X), torch.ones(n)),)
    cache = {}

    def sample_fn(nsamples):
        if nsamples not in cache:
            burnin = 100
            states = _stacked(defn, data, C, 40 + len(cache), alpha=1.5)
            g = rng(len(cache), "cpu").generator
            zs = []
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for t in range(-(-nsamples // C) + burnin):
                    states = blocked.sweep_chains(states, data, g, **ROUTES[route])
                    if t >= burnin:
                        zs.append(states.assignments.clone())
            za = torch.cat(zs).numpy()
            cache[nsamples] = [testutil.permutation_canonical(a) for a in za]
        return cache[nsamples]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=6000, ntries=3, kl_tol=0.03)


def _jax_stats(X, mask, z, K):
    hyp = {k: jnp.asarray(v) for k, v in jmodels.niw(X.shape[1]).canonical_hyper().items()}
    return jniw.stats_from_assignments(hyp, jnp.asarray(X), jnp.asarray(mask), jnp.asarray(z), K)


@pytest.mark.parametrize("route,budget", [("wide", 2e9), ("fused", 2e9), ("fused", 1.0),
                                          ("fallback", 2e9)])
def test_sweep_chains_restat_and_masking(route, budget):
    """Counts and suffstats per chain equal JAX's stats_from_assignments of
    the same z (rtol 1e-4, atol 1e-3: fp32 sums in another order);
    budget 1.0 takes the per-chain restat of the 1M x 256 shape. Masked
    rows are counted but add no stats."""
    r = np.random.default_rng(1)
    n, d, K, C = 200, 3, 6, 2
    X = r.normal(size=(n, d)).astype(np.float32)
    mask = (r.random(n) > 0.2).astype(np.float32)
    defn = st.model_definition(n, [models.niw(d)], k_max=K)
    data = ((torch.from_numpy(X), torch.from_numpy(mask)),)
    states = _stacked(defn, data, C, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = blocked.sweep_chains(states, data, rng(3, "cpu").generator, xx_budget_bytes=budget,
                                   **ROUTES[route])
    z = out.assignments.numpy()
    assert z.shape == (C, n) and out.counts.shape == (C, K)
    for c in range(C):
        np.testing.assert_array_equal(out.counts[c].numpy(), np.bincount(z[c], minlength=K))
        want = _jax_stats(X, mask, z[c], K)
        for leaf in ("n", "sum_x", "sum_xxT"):
            np.testing.assert_allclose(out.stats[0][leaf][c].numpy(), np.asarray(want[leaf]),
                                       rtol=1e-4, atol=1e-3, err_msg=leaf)
    # fully-masked data: stats stay exactly zero, every row still assigned
    data0 = ((torch.from_numpy(X), torch.zeros(n)),)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out0 = blocked.sweep_chains(states, data0, rng(3, "cpu").generator, xx_budget_bytes=budget,
                                    **ROUTES[route])
    assert float(out0.stats[0]["sum_x"].abs().sum()) == 0.0
    assert float(out0.stats[0]["sum_xxT"].abs().sum()) == 0.0
    assert out0.counts.sum(-1).tolist() == [n] * C


def test_sweep_chains_fallback_warns_once_and_serves_bbv(monkeypatch):
    monkeypatch.setattr(blocked, "_FALLBACK_WARNED", False)
    r = np.random.default_rng(4)
    n, d, K, C = 60, 3, 6, 2
    X = torch.tensor(r.normal(size=(n, d)), dtype=torch.float32)
    data = ((X, torch.ones(n)),)
    states = _stacked(st.model_definition(n, [models.niw(d)], k_max=K), data, C, 0)
    g = rng(0, "cpu").generator
    with pytest.warns(UserWarning, match="falling back") as caught:
        blocked.sweep_chains(states, data, g, d_max_xx=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        blocked.sweep_chains(states, data, g, d_max_xx=0)  # silent the second time
    assert len([w for w in caught if "falling back" in str(w.message)]) == 1
    # models other than niw take the per-chain route and still work
    B = torch.tensor(r.integers(0, 2, size=(n, 4)), dtype=torch.float32)
    datab = ((B, torch.ones(n)),)
    sb = _stacked(st.model_definition(n, [models.bbv(4)], k_max=K), datab, C, 2)
    outb = blocked.sweep_chains(sb, datab, g)
    assert outb.counts.shape == (C, K) and outb.counts.sum(-1).tolist() == [n] * C


# ---------------------------------------------------------------------------
# parallel.chains, convert, diagnostics
# ---------------------------------------------------------------------------
def test_stack_unstack_round_trip_and_vmap_sweep():
    r = np.random.default_rng(5)
    n, d, K = 50, 2, 5
    X = torch.tensor(r.normal(size=(n, d)), dtype=torch.float32)
    data = ((X, torch.ones(n)),)
    defn = st.model_definition(n, [models.niw(d)], k_max=K)
    g = rng(0, "cpu").generator
    singles = [st.initialize(defn, data, g, cluster_hp={"alpha": a}) for a in (0.5, 1.0, 2.0)]
    stacked = stack_states(singles)
    assert stacked.assignments.shape == (3, n) and stacked.stats[0]["sum_xxT"].shape == (3, K, d, d)
    assert stacked.cluster_hp["alpha"].tolist() == [0.5, 1.0, 2.0]
    for i, s in enumerate(singles):
        back = unstack_state(stacked, i)
        assert back.lik_names == s.lik_names and back.fixed == s.fixed
        assert torch.equal(back.assignments, s.assignments) and torch.equal(back.counts, s.counts)
        for leaf in s.stats[0]:
            assert torch.equal(back.stats[0][leaf], s.stats[0][leaf])
        for leaf in s.hypers[0]:
            assert torch.equal(back.hypers[0][leaf], s.hypers[0][leaf])
    # vmap_sweep: chain c of the result is sweep(chain c) with the generator in turn
    g1, g2 = rng(9, "cpu").generator, rng(9, "cpu").generator
    out = vmap_sweep(blocked.sweep)(stacked, data, g1)
    for i, s in enumerate(singles):
        assert torch.equal(unstack_state(out, i).assignments, blocked.sweep(s, data, g2).assignments)
    with pytest.raises(ValueError):
        stack_states([])
    with pytest.raises(ValueError, match="one model"):
        stack_states([singles[0], dataclasses.replace(singles[1], fixed=True)])


def _leaves(s):
    arrays = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return {
        "assignments": np.asarray(s.assignments), "counts": np.asarray(s.counts),
        "cluster_hp": arrays(s.cluster_hp), "stats": tuple(arrays(f) for f in s.stats),
        "hypers": tuple(arrays(h) for h in s.hypers), "lik_names": tuple(s.lik_names),
        "fixed": bool(s.fixed),
    }


def test_stacked_jax_state_converts_and_scores_per_chain():
    """jax.vmap(initialize) leaves convert with a leading C on every leaf;
    each chain's score_joint and heldout_logp equal JAX's vmap (rtol 1e-5)."""
    r = np.random.default_rng(6)
    n, d, K, C = 80, 3, 8, 3
    X = (r.normal(scale=3.0, size=(4, d))[r.integers(0, 4, n)] + r.normal(size=(n, d))).astype(np.float32)
    jdefn = jst.model_definition(n, [jmodels.niw(d)], k_max=K)
    jdata = ((jnp.asarray(X), jnp.ones(n)),)
    js = jax.vmap(lambda k: jst.initialize(jdefn, jdata, k, cluster_hp={"alpha": 1.0}))(
        jax.random.split(jax.random.key(0), C))
    stacked = convert.state_from_numpy(_leaves(js), device="cpu")
    assert stacked.assignments.shape == (C, n) and stacked.counts.shape == (C, K)
    assert all(v.shape[0] == C for v in stacked.hypers[0].values())
    Xh = r.normal(scale=3.0, size=(20, d)).astype(np.float32)
    want_score = np.asarray(jax.vmap(jst.score_joint)(js))
    want_lp = np.asarray(jax.vmap(
        lambda s: jst.heldout_logp(s, ((jnp.asarray(Xh), jnp.ones(20)),)))(js))
    for c in range(C):
        s = unstack_state(stacked, c)
        np.testing.assert_allclose(float(st.score_joint(s)), want_score[c], rtol=1e-5)
        got = st.heldout_logp(s, ((torch.from_numpy(Xh), torch.ones(20)),)).numpy()
        np.testing.assert_allclose(got, want_lp[c], rtol=1e-5, atol=1e-4)
    back = convert.state_to_numpy(stacked)
    np.testing.assert_array_equal(back["assignments"], np.asarray(js.assignments))


@pytest.mark.parametrize("shape", [(4, 200), (1, 150), (3, 31)])
def test_diagnostics_match_jax(shape):
    r = np.random.default_rng(shape[1])
    x = np.cumsum(r.normal(size=shape), axis=-1).astype(np.float32) * 0.1 + r.normal(size=shape)
    np.testing.assert_allclose(float(diagnostics.ess(x)), float(jdiag.ess(x)), rtol=1e-4)
    np.testing.assert_allclose(float(diagnostics.split_rhat(x)), float(jdiag.split_rhat(x)),
                               rtol=1e-4)
    got, want = diagnostics.summarize_traces(torch.from_numpy(x)), jdiag.summarize_traces(x)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k])
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4)
    # one chain given as [T]
    np.testing.assert_allclose(float(diagnostics.ess(x[0])), float(jdiag.ess(x[0])), rtol=1e-4)


def test_hdp_and_irm_chains_stack_unstack_and_sweep():
    """Family-generic chains (tests/test_parallel.py's HDP and IRM case):
    every tensor leaf gains the chain axis, static fields are shared, and
    vmap_sweep sweeps chain c as the sweep alone would, the generator in turn."""
    from common_tpu_torch import relational as irm
    from common_tpu_torch import topic
    from common_tpu_torch.data import sparse_ndarray_dataview, variadic_dataview
    from common_tpu_torch.relational import kernels as irm_kernels

    # HDP: 3 chains over one corpus
    r = np.random.default_rng(0)
    rows = [r.integers(0, 12, size=15) for _ in range(20)]
    data = topic.token_data(variadic_dataview(rows, device="cpu"))
    g = rng(0, "cpu").generator
    chains = [topic.initialize(data, 4, 12, g, n_docs=20) for _ in range(3)]
    batched = stack_states(chains)
    assert batched.z.shape == (3, 300) and batched.hypers["alpha"].shape == (3,)
    for c in range(3):
        assert torch.equal(unstack_state(batched, c).topic_word, chains[c].topic_word)
    g1, g2 = rng(9, "cpu").generator, rng(9, "cpu").generator
    swept = vmap_sweep(topic.blocked_sweep)
    for _ in range(3):
        batched = swept(batched, data, g1)
        chains = [topic.blocked_sweep(s, data, g2) for s in chains]
    assert not torch.equal(batched.z[0], batched.z[1])  # chains diverged
    for c in range(3):
        back = unstack_state(batched, c)
        assert torch.equal(back.z, chains[c].z) and float(back.topic_total.sum()) == 300

    # IRM: 2 chains over one self-relation
    rel = (r.random((8, 8)) < 0.5).astype(np.float32)
    defn = irm.model_definition([8], [((0, 0), models.bb)], k_max=4)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device="cpu")])
    ichains = [irm.initialize(defn, views, rng(10 + i, "cpu").generator, cluster_hps=[{"alpha": 1.0}])
               for i in range(2)]
    ib = stack_states(ichains)
    assert ib.assignments[0].shape == (2, 8) and ib.suffstats[0]["n"].shape == (2, 4, 4)
    assert ib.rel_domains == ((0, 0),) and ib.lik_names == ("bb",)
    g1, g2 = rng(11, "cpu").generator, rng(11, "cpu").generator
    isweep = vmap_sweep(irm_kernels.sweep)
    for _ in range(3):
        ib = isweep(ib, views, g1)
        ichains = [irm_kernels.sweep(s, views, g2) for s in ichains]
    np.testing.assert_array_equal(ib.counts[0].sum(-1).numpy(), [8, 8])
    for c in range(2):
        back = unstack_state(ib, c)
        assert torch.equal(back.assignments[0], ichains[c].assignments[0])
        assert torch.equal(back.suffstats[0]["heads"], ichains[c].suffstats[0]["heads"])
    other = irm.initialize(irm.model_definition([8], [((0, 0), models.gp)], k_max=4), views,
                           rng(0, "cpu").generator)
    with pytest.raises(ValueError, match="one model"):
        stack_states([ichains[0], other])
    with pytest.raises(ValueError, match="one model"):
        stack_states([ichains[0], chains[0]])
