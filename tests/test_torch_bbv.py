"""The port's Beta-Bernoulli config-2 path (path B) against the JAX package.

bbv's deterministic methods, the hyperprior functions and the linear score
table get the same numpy inputs on both sides (float32, rtol 1e-5 unless an
assert says otherwise). The samplers (slice sampling, the blocked sweeps)
are held to distributions: a KS test, the exact-enumeration oracle, and
recovery of planted clusters. On the CPU the fused sweep runs the linear
kernel's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.scipy.special import betaln as j_betaln
from scipy import stats as sps

from common_tpu import models as jmodels
from common_tpu import scalar_functions as jsf
from common_tpu import state as jst
from common_tpu import testutil
from common_tpu.likelihoods import bbv as jbbv
from common_tpu.ops.linear_assign import fused_linear_assign as j_linear
from common_tpu_torch import convert, models, rng
from common_tpu_torch import scalar_functions as sf
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked, slice_
from common_tpu_torch.likelihoods import bbv as tbbv
from common_tpu_torch.likelihoods.bbv import betaln
from common_tpu_torch.ops import linear_assign as la
from common_tpu_torch.runner import run_chain, runner

from test_gibbs_exact import exact_partition_posterior

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
N, D, K = 120, 6, 5


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **kw})


def _problem(seed=0):
    """Hypers, binary rows, mask and assignments (slot K-1 stays empty)."""
    r = np.random.default_rng(seed)
    hyper = {"alpha": r.uniform(0.5, 3.0, D).astype(np.float32),
             "beta": r.uniform(0.5, 3.0, D).astype(np.float32)}
    X = (r.random((N, D)) < r.uniform(0.1, 0.9, D)).astype(np.float32)
    mask = (r.random(N) > 0.2).astype(np.float32)
    gid = r.integers(0, K, N).astype(np.int32)
    gid[gid == K - 1] = K  # dropped
    return hyper, X, mask, gid


def _jstats(hyper, X, mask, gid):
    h = {k: jnp.asarray(v) for k, v in hyper.items()}
    return {k: np.asarray(v) for k, v in jbbv.stats_from_assignments(
        h, jnp.asarray(X), jnp.asarray(mask), jnp.asarray(gid), K).items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_stats_tx_and_init_match_jax():
    hyper, X, mask, gid = _problem()
    got = tbbv.stats_from_assignments(_t(hyper), torch.from_numpy(X), torch.from_numpy(mask),
                                      torch.from_numpy(gid), K)
    want = _jstats(hyper, X, mask, gid)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])
        assert got[k].dtype == torch.float32
    tx = tbbv.tx(_t(hyper), torch.from_numpy(X[3]), torch.tensor(1.0))
    jtx = jbbv.tx(_j(hyper), jnp.asarray(X[3]), 1.0)
    for k in jtx:
        _close(tx[k], jtx[k])
    zeros = tbbv.init_stats(_t(hyper), (K,))
    assert zeros["n"].shape == (K,) and zeros["heads"].shape == (K, D)


def test_validate_and_default_hyper():
    good = models.bbv(D).canonical_hyper(device="cpu")
    assert good["alpha"].shape == (D,) and good["alpha"].dtype == torch.float32
    with pytest.raises(ValueError, match="matching"):
        tbbv.validate_hyper({"alpha": np.ones(3), "beta": np.ones(4)}, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        tbbv.validate_hyper({"alpha": np.ones(3)}, device="cpu")
    with pytest.raises(ValueError):
        models.bbv(0)
    assert set(tbbv.default_hyper()) == {"alpha", "beta"}


def test_posterior_marginal_predictive_match_jax():
    hyper, X, mask, gid = _problem(1)
    stats = _jstats(hyper, X, mask, gid)
    th, ts = _t(hyper), _t(stats)
    jh, js = _j(hyper), _j(stats)
    for k, v in jbbv.posterior_hyper(jh, js).items():
        _close(tbbv.posterior_hyper(th, ts)[k], v)
    ml = tbbv.marginal_loglik(th, ts)
    _close(ml, jbbv.marginal_loglik(jh, js), rtol=1e-5, atol=1e-4)
    assert float(ml[K - 1]) == 0.0  # an empty slot scores exactly 0
    for row in (0, 7):
        _close(tbbv.pred_logpdf(th, ts, torch.from_numpy(X[row])),
               jbbv.pred_logpdf(jh, js, jnp.asarray(X[row])))
    want = np.stack([np.asarray(jbbv.pred_logpdf(jh, js, jnp.asarray(x))) for x in X[:20]])
    _close(tbbv.predictive_logpdf(tbbv.predictive(th, ts), torch.from_numpy(X[:20])), want)


def test_logpdf_batch_matches_jax_on_the_same_theta():
    hyper, X, mask, _ = _problem(2)
    p = np.random.default_rng(2).uniform(0.02, 0.98, size=(K, D)).astype(np.float32)
    got = tbbv.logpdf_batch({"p": torch.from_numpy(p)}, torch.from_numpy(X), torch.from_numpy(mask))
    want = jbbv.logpdf_batch({"p": jnp.asarray(p)}, jnp.asarray(X), jnp.asarray(mask))
    _close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("scale", [1.0, 30.0, 3e4])
def test_betaln_matches_jax(scale):
    """Both branches: lgamma below 8, the series above (counts of a 100k-row cluster)."""
    r = np.random.default_rng(int(scale))
    a = (r.uniform(0.05, 1.0, 500) * scale + 0.1).astype(np.float32)
    b = (r.uniform(0.05, 1.0, 500) * scale + 0.1).astype(np.float32)
    _close(betaln(torch.from_numpy(a), torch.from_numpy(b)), j_betaln(a, b), rtol=1e-5, atol=1e-4)


def test_sample_params_mean_matches_posterior():
    hyper, X, mask, gid = _problem(3)
    stats = _t(_jstats(hyper, X, mask, gid))
    g = rng(0, "cpu").generator
    draws = torch.stack([tbbv.sample_params(g, _t(hyper), stats)["p"] for _ in range(4000)])
    post = tbbv.posterior_hyper(_t(hyper), stats)
    want = post["alpha"] / (post["alpha"] + post["beta"])
    torch.testing.assert_close(draws.mean(0), want, atol=0.01, rtol=0)
    assert float(draws.min()) > 0.0 and float(draws.max()) < 1.0


@pytest.mark.parametrize("name,args,x", [
    ("log_exponential", (1.5,), [0.2, 3.0]),
    ("log_normal", (0.5, 2.0), [-1.0, 0.7]),
    ("log_gamma", (2.5, 0.7), [0.3, 4.0]),
])
def test_scalar_functions_match_jax(name, args, x):
    xs = np.asarray(x, np.float32)
    _close(getattr(sf, name)(*args)(torch.from_numpy(xs)), getattr(jsf, name)(*args)(xs))
    hyper = {"alpha": np.float32(x[0]), "beta": np.float32(x[1])}
    _close(getattr(sf, name)(*args, field="beta")(hyper), getattr(jsf, name)(*args, field="beta")(hyper))
    with pytest.raises(ValueError, match="field"):
        getattr(sf, name)(*args)(hyper)
    both = sf.sum_fns(sf.log_noninformative_beta(), getattr(sf, name)(*args, field="alpha"))
    jboth = jsf.sum_fns(jsf.log_noninformative_beta(), getattr(jsf, name)(*args, field="alpha"))
    _close(both(hyper), jboth(hyper))


# ---------------------------------------------------------------------------
# slice sampling
# ---------------------------------------------------------------------------
def _chain_slice(seed, x0, logf, n, **kw):
    g = rng(seed, "cpu").generator
    x, xs = torch.tensor(x0), []
    for _ in range(n):
        x = slice_.slice_sample(g, x, logf, **kw)
        xs.append(float(x))
    return np.asarray(xs)


def test_slice_samples_standard_normal():
    xs = _chain_slice(0, 0.3, lambda x: -0.5 * x * x, 4000, w=2.0)[500:]
    d, p = sps.kstest(xs[::5], "norm")
    assert p > 0.01, (d, p)


def test_slice_samples_beta_with_bounds():
    a, b = 3.0, 1.5
    xs = _chain_slice(1, 0.5, lambda x: (a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x), 4000,
                      w=0.3, lower=1e-6, upper=1 - 1e-6)[500:]
    d, p = sps.kstest(xs[::5], sps.beta(a, b).cdf)
    assert p > 0.01, (d, p)


def test_slice_returns_x0_when_no_proposal_lands():
    """A target whose slice holds only x0 exhausts the shrink cap: a no-op."""
    g = rng(2, "cpu").generator
    x = slice_.slice_sample(g, torch.tensor(0.25), lambda v: torch.where(v == 0.25, 0.0, -1e9), w=1.0)
    assert float(x) == 0.25


def test_slice_hp_moves_bbv_alpha_and_keeps_bounds():
    """hp on a bbv column's alpha: the chain moves, stays inside its bounds,
    and is pulled below a deliberately high start by tails-heavy data
    (tests/test_slice.py:74-104, on bbv)."""
    n, d = 40, 2
    r = np.random.default_rng(0)
    x = (r.random((n, d)) < 0.15).astype(np.float32)
    defn = st.model_definition(n, [models.bbv(d)], k_max=4)
    data = ((torch.from_numpy(x), torch.ones(n)),)
    s = st.initialize(defn, data, rng(0, "cpu").generator, assignment=np.zeros(n, np.int32),
                      feature_hps=[{"alpha": np.full(d, 5.0), "beta": np.ones(d)}])
    spec = {0: {"alpha": {"prior": sf.log_exponential(0.5), "w": 1.0, "bounds": (1e-4, 100.0)}}}
    g = rng(3, "cpu").generator
    alphas = []
    for _ in range(600):
        s = slice_.hp(s, data, g, spec)
        alphas.append(s.hypers[0]["alpha"].numpy().copy())
    alphas = np.asarray(alphas)[100:]
    assert alphas.std(0).min() > 0.05
    assert np.all((alphas > 1e-4) & (alphas < 100.0))
    assert alphas.mean() < 5.0
    assert torch.equal(s.hypers[0]["beta"], torch.ones(d))  # not in the spec: untouched


def test_slice_hp_cluster_alpha_stays_in_bounds():
    defn = st.model_definition(30, [models.bbv(2)], k_max=6)
    data = ((torch.zeros(30, 2), torch.ones(30)),)
    s = st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.0})
    g = rng(1, "cpu").generator
    vals = []
    for _ in range(100):
        s = slice_.hp(s, data, g, {}, cluster={"prior": sf.log_exponential(1.0), "w": 0.5,
                                               "bounds": (0.1, 5.0)})
        vals.append(float(s.cluster_hp["alpha"]))
    assert 0.1 < min(vals) and max(vals) < 5.0 and np.std(vals) > 0.05


# ---------------------------------------------------------------------------
# the linear assignment kernel's module
# ---------------------------------------------------------------------------
def _linear_problem(n=900, d=32, k=6, seed=0):
    """Near-deterministic block-structured columns (tests/test_pallas.py:147)."""
    r = np.random.default_rng(seed)
    p = np.where(r.uniform(size=(k, d)) < 0.5, 0.03, 0.97).astype(np.float32)
    z = r.integers(0, k, n)
    X = (r.uniform(size=(n, d)) < p[z]).astype(np.float32)
    W = (np.log(p) - np.log1p(-p)).astype(np.float32)
    base = np.log1p(-p).sum(-1).astype(np.float32)
    return X, W, base, z


def test_linear_scores_match_jax():
    X, W, base, _ = _linear_problem()
    want = np.asarray(jnp.asarray(X) @ jnp.asarray(W).T + jnp.asarray(base)[None, :])
    _close(la.linear_scores(*map(torch.from_numpy, (X, W, base))), want, rtol=1e-5, atol=1e-4)


def test_linear_argmax_matches_pallas_interpret():
    """The interpreter's PRNG returns constant bits, so the Pallas kernel is
    a seed-independent argmax of the scores there; near-deterministic
    columns make it the planted cluster on nearly every row."""
    X, W, base, zt = _linear_problem()
    with pltpu.force_tpu_interpret_mode():
        zj = np.asarray(j_linear(*map(jnp.asarray, (X, W, base)), 7))
    zp = la.linear_scores(*map(torch.from_numpy, (X, W, base))).argmax(-1).numpy()
    assert (zj == zp).mean() > 0.999
    # and the plain sampler draws the planted cluster on the informative rows
    g = torch.Generator().manual_seed(0)
    z = la.linear_assign_plain(*map(torch.from_numpy, (X, W, base)), g).numpy()
    assert (z == zt).mean() > 0.97


def test_linear_wrapper_dominance_padding_and_plain_seeding():
    X, W, base, _ = _linear_problem(n=1500, k=5)
    t = [torch.from_numpy(a) for a in (X, W, base)]
    seed = torch.tensor([3], dtype=torch.int32)
    before = la.fused_linear_assign.launches
    z = la.fused_linear_assign(*t, seed)
    assert z.shape == (1500,) and z.dtype == torch.int32
    assert int(z.min()) >= 0 and int(z.max()) < 5
    assert torch.equal(z, la.linear_assign_plain(*t, torch.Generator().manual_seed(3)))
    dom = t[2].clone()
    dom[2] = 1e4
    assert (la.fused_linear_assign(t[0], t[1], dom, seed) == 2).all()
    assert la.fused_linear_assign.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        la.fused_linear_assign(*(a.to("meta") for a in t), seed.to("meta"))
    with pytest.raises(ValueError, match="shape"):
        la.fused_linear_assign(t[0], t[1][:, :3], t[2], seed)
    # the noise check, as the CUDA kernel draws it: word j of the Philox
    # call with counter (row, g, 0, 1) is cluster 4g + j
    from common_tpu_torch.ops.philox import gumbel_from_bits, philox4x32_10, philox_key
    v = la.linear_philox_scores(*t, seed, row0=10) - la.linear_scores(*t)
    rows = torch.arange(10, 1510)
    zero = torch.zeros_like(rows)
    want = torch.cat([torch.stack(philox4x32_10((rows, zero + g, zero, zero + 1), philox_key(seed)), -1)
                      for g in (0, 1)], -1)[:, :5]
    torch.testing.assert_close(v, gumbel_from_bits(want), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# sweeps, state, runner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["assign_blocked", "assign_blocked_fused"])
def test_bbv_sweep_matches_enumeration(kernel):
    """tests/test_blocked.py:105 for the port: bbv through each sweep vs the
    exact partition posterior (kl_tol 0.03)."""
    r = np.random.default_rng(2)
    n, d = 4, 3
    x = r.integers(0, 2, size=(n, d)).astype(np.float32)
    chp = {"alpha": 1.0}
    exact = exact_partition_posterior(
        jst.model_definition(n, [jmodels.bbv(d)], k_max=5), ((jnp.asarray(x), jnp.ones(n)),), chp)
    defn = st.model_definition(n, [models.bbv(d)], k_max=16)
    data = ((torch.from_numpy(x), torch.ones(n)),)
    cache = {}

    def sample_fn(nsweeps):
        if nsweeps not in cache:
            seed = len(cache)
            s0 = st.initialize(defn, data, rng(seed + 100, "cpu").generator, cluster_hp=chp)
            _, trace = run_chain(s0, data, rng(seed, "cpu").generator, nsweeps + 100, [kernel])
            cache[nsweeps] = [testutil.permutation_canonical(a)
                              for a in trace["assignments"][100:].numpy()]
        return cache[nsweeps]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=6000, ntries=3, kl_tol=0.03)


def _bbv_recovery_problem(n=600, d=24, k=3, seed=0):
    r = np.random.default_rng(seed)
    probs = np.where(r.random((k, d)) < 0.5, 0.15, 0.85)
    zt = r.integers(0, k, n)
    X = (r.random((n, d)) < probs[zt]).astype(np.float32)
    return X, zt


def test_fused_bbv_stats_equal_the_plain_restat_of_its_draw():
    X, _ = _bbv_recovery_problem()
    mask = np.ones(len(X), np.float32)
    mask[::7] = 0.0
    defn = st.model_definition(len(X), [models.bbv(X.shape[1])], k_max=8)
    data = ((torch.from_numpy(X), torch.from_numpy(mask)),)
    s = st.initialize(defn, data, rng(3, "cpu").generator)
    out = blocked.sweep_fused(s, data, rng(4, "cpu").generator)
    plain = blocked.restat(s, data, out.assignments)
    assert torch.equal(out.counts, plain.counts) and int(out.counts.sum()) == len(X)
    for leaf in ("n", "heads"):
        torch.testing.assert_close(out.stats[0][leaf], plain.stats[0][leaf], rtol=0, atol=0)
    assert float(out.stats[0]["n"].sum()) == float(mask.sum())


def test_heldout_logp_of_a_converted_bbv_state_matches_jax(monkeypatch):
    monkeypatch.setattr(st, "HELDOUT_BATCH", 16)  # 37 rows: three batches, the last ragged
    hyper, X, mask, gid = _problem(4)
    jdefn = jst.model_definition(N, [jmodels.bbv(D)], k_max=K)
    js = jst.initialize(jdefn, ((jnp.asarray(X), jnp.asarray(mask)),), jax.random.key(0),
                        cluster_hp={"alpha": 1.3}, feature_hps=[hyper],
                        assignment=jnp.asarray(np.where(gid < K, gid, 0)))
    leaves = {
        "assignments": np.asarray(js.assignments), "counts": np.asarray(js.counts),
        "cluster_hp": {k: np.asarray(v) for k, v in js.cluster_hp.items()},
        "stats": tuple({k: np.asarray(v) for k, v in f.items()} for f in js.stats),
        "hypers": tuple({k: np.asarray(v) for k, v in h.items()} for h in js.hypers),
        "lik_names": tuple(js.lik_names), "fixed": bool(js.fixed),
    }
    s = convert.state_from_numpy(leaves, device="cpu")
    r = np.random.default_rng(5)
    Xh = (r.random((37, D)) < 0.4).astype(np.float32)
    mh = np.ones(37, np.float32)
    mh[4] = 0.0
    want = jst.heldout_logp(js, ((jnp.asarray(Xh), jnp.asarray(mh)),))
    got = st.heldout_logp(s, ((torch.from_numpy(Xh), torch.from_numpy(mh)),))
    _close(got, want, rtol=1e-5, atol=1e-4)
    _close(st.score_joint(s), jst.score_joint(js), rtol=1e-5, atol=1e-3)


def test_runner_fused_bbv_with_slice_hp_recovers_clusters():
    X, zt = _bbv_recovery_problem()
    n, d = X.shape
    defn = st.model_definition(n, [models.bbv(d)], k_max=16)
    data = ((torch.from_numpy(X), torch.ones(n)),)
    s = st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.0})
    bounds = {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)}
    config = [("assign_blocked_fused", {}),
              ("slice_hp", {"specs": {0: {"alpha": bounds, "beta": bounds}},
                            "cluster": {"prior": sf.log_exponential(1.0), "w": 0.5,
                                        "bounds": (1e-4, 1e4)}})]
    run = runner(defn, data, s, config)
    run.run(rng(1, "cpu").generator, 30)
    zs = run.assignment_trace
    co = np.mean([a[:, None] == a[None, :] for a in zs[-10:]], axis=0) > 0.5
    assert (co == (zt[:, None] == zt[None, :])).mean() > 0.95
    assert np.isfinite(run.score_trace).all()
    out = run.get_latent()
    assert int(out.counts.sum()) == n
    a = out.hypers[0]["alpha"]
    assert bool(((a >= 0.5) & (a <= 50.0)).all()) and not torch.equal(a, torch.ones(d))
