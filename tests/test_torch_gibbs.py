"""The port's collapsed Gibbs family against the JAX package.

The samplers (`assign`, Neal-8 `assign_resample`, `assign_fixed`, with
`theta` or `slice_theta` for bbnc) are held to the exact-enumeration oracle
of tests/test_gibbs_exact.py: the exact partition posterior is computed by
the JAX package, the port's `run_chain` draws the samples, and
`assert_discrete_dist_approx` requires KL(exact || sampled) < 0.02.

The deterministic pieces get the same numpy inputs on both sides in
float64 (`jax.enable_x64`), with the tolerance stated at each assert.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps
from torch.utils._python_dispatch import TorchDispatchMode

from common_tpu import models as jmodels
from common_tpu import scalar_functions as jsf
from common_tpu import state as jst
from common_tpu import testutil
from common_tpu.kernels import gibbs as jgibbs
from common_tpu_torch import convert, models, rng
from common_tpu_torch import scalar_functions as sf
from common_tpu_torch import state as st
from common_tpu_torch.kernels import gibbs, slice_
from common_tpu_torch.runner import KERNELS, run_chain

from test_gibbs_exact import exact_partition_posterior

torch.set_num_threads(2)

F64 = dict(rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the exact-enumeration oracle
# ---------------------------------------------------------------------------
def _bb(n, seed):
    r = np.random.default_rng(seed)
    return [(r.integers(0, 2, size=n), models.bb, jmodels.bb)]


def _nich(n, seed):
    r = np.random.default_rng(seed)
    x = np.concatenate([r.normal(-2, 0.5, n // 2), r.normal(2, 0.5, n - n // 2)])
    return [(x.astype(np.float32), models.nich, jmodels.nich)]


def _niw(n, seed):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(n, 2)).astype(np.float32), models.niw(2), jmodels.niw(2))]


def _mixed(n, seed):
    r = np.random.default_rng(seed)
    return [(r.integers(0, 2, size=n), models.bb, jmodels.bb),
            (r.normal(size=n).astype(np.float32), models.nich, jmodels.nich)]


# name -> (columns, cluster hypers, kernel config, sweeps); problems of
# tests/test_gibbs_exact.py, n=4 rows, k_max=5
ORACLE = {
    "bb": (_bb(4, 0), {"alpha": 1.5}, ["assign"], 3000),
    "nich": (_nich(4, 0), {"alpha": 1.0}, ["assign"], 3000),
    "niw": (_niw(4, 0), {"alpha": 2.0}, ["assign"], 3000),
    "mixed": (_mixed(4, 3), {"alpha": 1.0}, ["assign"], 3000),
    "neal8_m2": (_bb(4, 5), {"alpha": 1.5}, [("assign_resample", {"m": 2})], 3000),
}


def _port_data(cols):
    return tuple((torch.from_numpy(np.asarray(x)), torch.ones(len(x))) for x, _, _ in cols)


def _jax_data(cols):
    return tuple((jnp.asarray(x), jnp.ones(len(x))) for x, _, _ in cols)


def _port_samples(defn, data, chp, config, nsweeps, seed, fixed=False, burnin=100):
    s = st.initialize(defn, data, rng(seed + 100, "cpu").generator, cluster_hp=chp, fixed=fixed)
    _, trace = run_chain(s, data, rng(seed, "cpu").generator, nsweeps + burnin, config)
    return trace["assignments"][burnin:].numpy()


def _check(exact, defn, data, chp, config, nsweeps):
    cache = {}

    def sample_fn(n):
        if n not in cache:
            z = _port_samples(defn, data, chp, config, n, seed=len(cache))
            cache[n] = [testutil.permutation_canonical(a) for a in z]
        return cache[n]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=nsweeps, ntries=3, kl_tol=0.02)


@pytest.mark.parametrize("name", list(ORACLE))
def test_collapsed_gibbs_matches_enumeration(name):
    cols, chp, config, nsweeps = ORACLE[name]
    n = len(cols[0][0])
    exact = exact_partition_posterior(
        jst.model_definition(n, [j for _, _, j in cols], k_max=5), _jax_data(cols), chp)
    defn = st.model_definition(n, [t for _, t, _ in cols], k_max=5)
    _check(exact, defn, _port_data(cols), chp, config, nsweeps)


@pytest.mark.parametrize("theta_kernel", [("theta", {}), ("slice_theta", {"w": 0.3})])
def test_neal8_bbnc_nonconjugate_matches_enumeration(theta_kernel):
    """bbnc through Neal-8 (m=3) and the exact or the slice theta kernel.

    The exact target is the analytically collapsed posterior (bbnc is bb
    with p explicit), so the oracle scores partitions with the bb marginal;
    the sampler never uses it.
    """
    x = np.random.default_rng(4).integers(0, 2, size=4)
    chp = {"alpha": 1.5}
    exact = exact_partition_posterior(jst.model_definition(4, [jmodels.bb], k_max=5),
                                      ((jnp.asarray(x), jnp.ones(4)),), chp)
    defn = st.model_definition(4, [models.bbnc], k_max=5)
    data = ((torch.from_numpy(x), torch.ones(4)),)
    _check(exact, defn, data, chp, [("assign_resample", {"m": 3}), theta_kernel], 4000)


def test_fixed_k_gibbs_matches_enumeration():
    """Fixed-K Dirichlet state: enumeration over labelled assignments."""
    r = np.random.default_rng(6)
    n, K = 4, 3
    x = r.integers(0, 2, size=n)
    chp = {"alphas": np.array([0.8, 1.0, 1.2], np.float32)}
    jdefn = jst.model_definition(n, [jmodels.bb], k_max=K)
    jdata = ((jnp.asarray(x), jnp.ones(n)),)
    assignments = list(itertools.product(range(K), repeat=n))
    scores = [float(jst.score_joint(jst.initialize(jdefn, jdata, jax.random.key(0), cluster_hp=chp,
                                                   assignment=jnp.asarray(a, jnp.int32), fixed=True)))
              for a in assignments]
    exact = dict(zip(assignments, testutil.scores_to_probs(scores)))
    defn = st.model_definition(n, [models.bb], k_max=K)
    data = ((torch.from_numpy(x), torch.ones(n)),)
    cache = {}

    def sample_fn(nsweeps):
        if nsweeps not in cache:
            z = _port_samples(defn, data, chp, ["assign_fixed"], nsweeps, seed=len(cache) + 7, fixed=True)
            cache[nsweeps] = [tuple(a) for a in z.tolist()]
        return cache[nsweeps]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=3000, ntries=3, kl_tol=0.02)


# ---------------------------------------------------------------------------
# deterministic pieces, float64 against JAX
# ---------------------------------------------------------------------------
N, K = 14, 6


def _leaves(s):
    arrays = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return {"assignments": np.asarray(s.assignments), "counts": np.asarray(s.counts),
            "cluster_hp": arrays(s.cluster_hp), "stats": tuple(arrays(f) for f in s.stats),
            "hypers": tuple(arrays(h) for h in s.hypers), "lik_names": tuple(s.lik_names),
            "fixed": bool(s.fixed)}


NIW_HYPER = {"mu0": np.array([0.3, -0.2]), "kappa": np.float64(0.8),
             "psi": np.array([[1.5, 0.2], [0.2, 0.9]]), "nu": np.float64(3.5)}
NICH_HYPER = {"mu": np.float64(0.1), "kappa": np.float64(1.3), "sigmasq": np.float64(0.7),
              "nu": np.float64(2.5)}


def _f64_problem(seed=0):
    """An niw + nich state in float64 on both sides; row 5 alone in slot 4,
    slot 5 empty, row 2 unassigned, row 7's nich cell masked."""
    r = np.random.default_rng(seed)
    X = r.normal(scale=2.0, size=(N, 2))
    y = r.normal(size=N)
    mask = np.ones(N)
    mask[7] = 0.0
    z = r.integers(0, 4, N).astype(np.int32)
    z[5], z[2] = 4, -1
    with jax.enable_x64(True):
        jdata = ((jnp.asarray(X), jnp.ones(N)), (jnp.asarray(y), jnp.asarray(mask)))
        js = jst.initialize(jst.model_definition(N, [jmodels.niw(2), jmodels.nich], k_max=K), jdata,
                            jax.random.key(0), cluster_hp={"alpha": np.float64(1.3)},
                            feature_hps=[NIW_HYPER, NICH_HYPER], assignment=jnp.asarray(z))
        leaves = _leaves(js)
    data = ((torch.from_numpy(X), torch.ones(N, dtype=torch.float64)),
            (torch.from_numpy(y), torch.from_numpy(mask)))
    return js, jdata, convert.state_from_numpy(leaves, device="cpu"), data


def _assert_state_equal(got, want_js, tol=F64):
    want = _leaves(want_js)
    np.testing.assert_array_equal(got.assignments.numpy(), want["assignments"])
    np.testing.assert_array_equal(got.counts.numpy(), want["counts"])
    for g, w in zip(got.stats, want["stats"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k], err_msg=k, **tol)


def test_remove_and_add_value_match_jax_and_clear_the_emptied_slot():
    js, jdata, s, data = _f64_problem()
    assert s.stats[0]["n"].dtype == torch.float64
    with jax.enable_x64(True):
        j_removed = jst.remove_value(js, jdata, 5)  # row 5 was alone in slot 4
        j_added = jst.add_value(j_removed, jdata, 5, jnp.asarray(1))
        j_removed7 = jst.remove_value(js, jdata, 7)  # masked nich cell
        j_unassigned = jst.remove_value(js, jdata, 2)
    removed = st.remove_value(s, data, 5)
    _assert_state_equal(removed, j_removed)
    assert int(removed.counts[4]) == 0 and int(removed.assignments[5]) == -1
    for f in removed.stats:  # the zero-cleared slot: exact zeros on both sides
        for k, v in f.items():
            assert torch.equal(v[4], torch.zeros_like(v[4])), k
    _assert_state_equal(st.add_value(removed, data, 5, torch.tensor(1)), j_added)
    _assert_state_equal(st.add_value(removed, data, 5, 1), j_added)
    _assert_state_equal(st.remove_value(s, data, 7), j_removed7)
    _assert_state_equal(st.remove_value(s, data, 2), j_unassigned)  # a no-op
    # the functional forms leave their input unchanged
    np.testing.assert_array_equal(s.assignments.numpy(), _leaves(js)["assignments"])


def test_zero_clear_kills_float_drift():
    """fp32: a row moved in and out of a slot many times leaves exact zeros
    once the slot empties, so the slot's marginal is exactly 0 (NIW's jitter
    is gated on n > 0)."""
    r = np.random.default_rng(1)
    X = r.normal(scale=3.0, size=(6, 2)).astype(np.float32)
    defn = st.model_definition(6, [models.niw(2)], k_max=4)
    data = ((torch.from_numpy(X), torch.ones(6)),)
    s = st.initialize(defn, data, rng(0, "cpu").generator, assignment=np.array([0, 0, 0, 1, 1, 2], np.int32))
    for _ in range(50):
        for eid in (0, 1, 2):
            s = st.add_value(st.remove_value(s, data, eid), data, eid, 3)
        for eid in (0, 1, 2):
            s = st.add_value(st.remove_value(s, data, eid), data, eid, 0)
    assert int(s.counts[3]) == 0
    for k, v in s.stats[0].items():
        assert torch.equal(v[3], torch.zeros_like(v[3])), k
    ml = s.likelihoods()[0].marginal_loglik(s.hypers[0], s.stats[0])
    assert float(ml[3]) == 0.0


def test_entity_ops_and_the_row_step_take_a_stack():
    """`remove_value_`, `add_value_` and `gibbs._row_sweep_step` on a stack
    of three states (`parallel.stack_states`, as block-SMC's particles) give
    each state's own result, float64: niw, nich (row 7 masked) and bnb,
    whose tx reads its hyper r, different in each state. Row 5 is alone in
    slot 4 of state 0 (its removal zero-clears the slot) and unassigned in
    state 1 (its removal is a no-op there)."""
    from common_tpu_torch.parallel import stack_states, unstack_state

    r = np.random.default_rng(3)
    X, y, w = r.normal(scale=2.0, size=(N, 2)), r.normal(size=N), r.integers(0, 6, N)
    mask = np.ones(N)
    mask[7] = 0.0
    data = ((torch.from_numpy(X), torch.ones(N, dtype=torch.float64)),
            (torch.from_numpy(y), torch.from_numpy(mask)), (torch.from_numpy(w), torch.ones(N)))
    defn = st.model_definition(N, [models.niw(2), models.nich, models.bnb], k_max=K)
    zs = [r.integers(0, 4, N).astype(np.int32) for _ in range(3)]
    zs[0][5], zs[1][5] = 4, -1
    states = [st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 0.5 + p},
                            feature_hps=[NIW_HYPER, NICH_HYPER, {"alpha": 2.0, "beta": 3.0, "r": 1.0 + p}],
                            assignment=z)
              for p, z in enumerate(zs)]
    stack = stack_states(states)

    def same(got, want):
        for p, s in enumerate(want):
            g = unstack_state(got, p)
            assert torch.equal(g.assignments, s.assignments) and torch.equal(g.counts, s.counts)
            for gf, sf_ in zip(g.stats, s.stats):
                for k in sf_:
                    np.testing.assert_allclose(gf[k].numpy(), sf_[k].numpy(), err_msg=k, **F64)

    removed = st.remove_value_(st.working_copy(stack), data, 5)
    one = [st.remove_value(s, data, 5) for s in states]
    same(removed, one)
    assert all(torch.equal(v[0, 4], torch.zeros_like(v[0, 4])) for f in removed.stats for v in f.values())
    gid = torch.tensor([1, 2, 4])
    same(st.add_value_(st.working_copy(removed), data, 5, gid),
         [st.add_value(s, data, 5, gid[p]) for p, s in enumerate(one)])
    noise = torch.from_numpy(r.gumbel(size=(3, K)))
    moved, slot = gibbs._row_sweep_step(data, 1, rng(1, "cpu").generator, st.working_copy(stack), 3, noise)
    want = [gibbs._row_sweep_step(data, 1, rng(1, "cpu").generator, st.working_copy(s), 3, noise[p])
            for p, s in enumerate(states)]
    same(moved, [s for s, _ in want])
    assert slot.tolist() == [int(g) for _, g in want]


def test_score_value_matches_jax():
    """The predictive terms are float64 on both sides; the JAX package takes
    the CRP weights log n_k and log alpha in float32 (state.py:283), hence
    atol 1e-6."""
    js, jdata, s, data = _f64_problem(2)
    for eid in (0, 7):
        with jax.enable_x64(True):
            want = np.asarray(jst.score_value(js, jdata, eid))
        got = st.score_value(s, data, eid).numpy()
        assert got.shape == (K,)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_aux_slot_mask_matches_jax(m):
    counts = np.array([0, 3, 0, 1, 0, 0, 2, 0], np.int32)
    want = np.asarray(jgibbs._aux_slot_mask(jnp.asarray(counts), m))
    np.testing.assert_array_equal(gibbs._aux_slot_mask(torch.from_numpy(counts), m).numpy(), want)


def test_hp_grid_scores_match_jax():
    """Pre-Gumbel grid scores, float64: the marginal-likelihood sums agree to
    1e-9; the priors are float32 on both sides (scalar_functions), hence the
    atol 1e-6 on the total."""
    js, _, s, _ = _f64_problem(3)
    niw_grid = [{**NIW_HYPER, "kappa": k, "nu": v} for k, v in ((0.5, 2.5), (1.0, 3.0), (2.0, 6.0))]
    nich_grid = [{**NICH_HYPER, "sigmasq": v} for v in (0.2, 0.7, 1.9, 4.0)]
    cases = [(0, niw_grid, sf.log_exponential(1.0, field="kappa"), jsf.log_exponential(1.0, field="kappa")),
             (1, nich_grid, sf.log_gamma(2.0, 1.0, field="sigmasq"),
              jsf.log_gamma(2.0, 1.0, field="sigmasq"))]
    for fid, grid, prior, jprior in cases:
        got, stacked = gibbs.hp_grid_scores(s, fid, grid, prior)
        with jax.enable_x64(True):
            jlik = js.likelihoods()[fid]
            active = js.counts > 0
            want = np.array([
                float(jprior(h) + jnp.sum(jnp.where(active, jlik.marginal_loglik(
                    {k: jnp.asarray(v) for k, v in h.items()}, js.stats[fid]), 0.0)))
                for h in grid])
        assert got.dtype == torch.float64 and got.shape == (len(grid),)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-6)
        for k in grid[0]:
            np.testing.assert_array_equal(stacked[k].numpy(), np.stack([np.asarray(h[k]) for h in grid]))
    # the draw is one of the grid points, for every feature in the spec
    out = gibbs.hp(s, {0: {"prior": cases[0][2], "grid": niw_grid}}, rng(0, "cpu").generator)
    assert any(float(out.hypers[0]["kappa"]) == h["kappa"] for h in niw_grid)
    assert out.hypers[1] is s.hypers[1]


def test_cluster_hp_grid_scores_match_jax():
    """The JAX package scores the EPPF in float32 (state.py:368-386): rtol 1e-6."""
    js, _, s, _ = _f64_problem(4)
    grid = np.geomspace(0.1, 10, 30)
    got, g = gibbs.cluster_hp_grid_scores(s, sf.log_exponential(1.0), grid)
    with jax.enable_x64(True):
        want = np.array([float(jsf.log_exponential(1.0)(a) + jst.score_assignment(
            dataclasses.replace(js, cluster_hp={"alpha": jnp.asarray(a)}))) for a in grid])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(g.numpy(), grid)
    out = gibbs.cluster_hp(s, sf.log_exponential(1.0), grid, rng(1, "cpu").generator)
    assert float(out.cluster_hp["alpha"]) in grid.tolist()


def test_escobar_west_odds_match_jax_and_the_chain_targets_the_posterior():
    kplus, n, log_eta = 3.0, 40.0, np.log(np.array([0.05, 0.3, 0.9]))
    for a, b in ((1.0, 1.0), (2.0, 0.5)):
        got = gibbs.escobar_west_odds(torch.tensor(kplus, dtype=torch.float64), torch.tensor(n, dtype=torch.float64),
                                      torch.from_numpy(log_eta), a, b)
        with jax.enable_x64(True):  # the expression of common_tpu/kernels/gibbs.py:216
            want = (a + jnp.asarray(kplus) - 1.0) / (jnp.asarray(n) * (b - jnp.asarray(log_eta)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    # stationary law: p(alpha | K+, n) prop. to Gamma(alpha; 1, 1) alpha^K+ Gamma(alpha) / Gamma(alpha + n)
    z = np.array([0] * 20 + [1] * 12 + [2] * 8, np.int32)
    defn = st.model_definition(40, [models.bb], k_max=6)
    s = st.initialize(defn, ((torch.zeros(40), torch.ones(40)),), rng(0, "cpu").generator, assignment=z)
    g = rng(5, "cpu").generator
    draws = []
    for _ in range(3000):
        s = gibbs.cluster_hp_escobar_west(s, g)
        draws.append(float(s.cluster_hp["alpha"]))
    from scipy.special import gammaln
    grid = np.linspace(1e-4, 15, 20000)
    logp = -grid + 3 * np.log(grid) + gammaln(grid) - gammaln(grid + 40)
    p = np.exp(logp - logp.max())
    mean = (grid * p).sum() / p.sum()
    sd = np.sqrt(((grid - mean) ** 2 * p).sum() / p.sum())
    # 3000 Gibbs draws, nearly independent: the mean within 4 standard errors
    assert abs(np.mean(draws) - mean) < 4 * sd / np.sqrt(3000), (np.mean(draws), mean)
    assert abs(np.std(draws) - sd) < 0.1 * sd


def _bbnc_state():
    defn = st.model_definition(6, [models.bbnc], k_max=4)
    data = ((torch.tensor([1, 1, 1, 0, 1, 0]), torch.ones(6)),)
    return st.initialize(defn, data, rng(0, "cpu").generator, assignment=np.array([0, 0, 0, 1, 1, 1], np.int32)), data


def test_theta_on_bbnc_matches_sample_params_moments():
    """gibbs.theta draws p | data exactly: slot 0 Beta(4, 1), slot 1 Beta(2, 3),
    the empty slots the prior Beta(1, 1); 4000 draws, means within 0.015 and
    standard deviations within 0.015 (about 5 standard errors)."""
    s, _ = _bbnc_state()
    g = rng(1, "cpu").generator
    ps = torch.stack([gibbs.theta(s, g).stats[0]["p"] for _ in range(4000)]).numpy()
    for slot, (a, b) in enumerate(((4, 1), (2, 3), (1, 1), (1, 1))):
        assert abs(ps[:, slot].mean() - sps.beta(a, b).mean()) < 0.015, slot
        assert abs(ps[:, slot].std() - sps.beta(a, b).std()) < 0.015, slot
    out = gibbs.theta(s, g)
    assert torch.equal(out.stats[0]["heads"], s.stats[0]["heads"])  # only the latent moves


def test_slice_theta_on_bbnc_matches_the_exact_conditional():
    """tests/test_slice.py:47 for the port: KS against Beta(4, 1) and Beta(2, 3)."""
    s, _ = _bbnc_state()
    g = rng(2, "cpu").generator
    ps = []
    for _ in range(3000):
        s = slice_.theta(s, g, w=0.3)
        ps.append(s.stats[0]["p"].numpy().copy())
    ps = np.asarray(ps)[500:]
    _, p0 = sps.kstest(ps[::5, 0], sps.beta(4, 1).cdf)
    _, p1 = sps.kstest(ps[::5, 1], sps.beta(2, 3).cdf)
    assert p0 > 0.01 and p1 > 0.01, (p0, p1)
    assert np.all((ps > 0) & (ps < 1))


# ---------------------------------------------------------------------------
# the sweep's contract
# ---------------------------------------------------------------------------
class _HostReads(TorchDispatchMode):
    """Records every op that copies a device value to the host or sizes its
    output by data (on a card each waits for the device)."""

    WAITS = ("_local_scalar_dense", "nonzero", "unique", "masked_select", "is_nonzero", "equal")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(name.startswith(w) for w in self.WAITS):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("model,m", [("niw", 1), ("bbnc", 3), ("mixed", 2)])
def test_sweep_reads_nothing_back_and_leaves_its_input_unchanged(model, m):
    r = np.random.default_rng(0)
    n = 30
    cols = {"niw": [(r.normal(size=(n, 2)).astype(np.float32), models.niw(2))],
            "bbnc": [(r.integers(0, 2, n), models.bbnc)],
            "mixed": [(r.integers(0, 3, n), models.dd(3)), (r.normal(size=n).astype(np.float32), models.nich),
                      (r.poisson(2.0, n), models.gp)]}[model]
    defn = st.model_definition(n, [d for _, d in cols], k_max=8)
    data = tuple((torch.from_numpy(x), torch.ones(n)) for x, _ in cols)
    s = st.initialize(defn, data, rng(0, "cpu").generator)
    before = convert.state_to_numpy(s)
    mode = _HostReads()
    with mode:
        out = gibbs.assign_resample(s, data, rng(1, "cpu").generator, m=m)
    assert mode.seen == []
    after = convert.state_to_numpy(s)
    np.testing.assert_array_equal(after["assignments"], before["assignments"])
    for a, b in zip(after["stats"], before["stats"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # the swept state is consistent: counts and stats equal a restat of its z
    fresh = st.compute_stats(defn, out.hypers, data, out.assignments)
    assert torch.equal(out.counts, st._assignment_counts(out.assignments, 8))
    for f, lik in zip(range(len(cols)), out.likelihoods()):
        for k, v in fresh[f].items():
            if k not in lik.latent_leaves:
                torch.testing.assert_close(out.stats[f][k], v, rtol=1e-5, atol=1e-4)


def test_assign_fixed_refuses_a_crp_state_and_the_registry_is_complete():
    defn = st.model_definition(5, [models.bb], k_max=3)
    data = ((torch.tensor([0, 1, 1, 0, 1]), torch.ones(5)),)
    s = st.initialize(defn, data, rng(0, "cpu").generator)
    with pytest.raises(ValueError, match="fixed-K"):
        gibbs.assign_fixed(s, data, rng(1, "cpu").generator)
    from common_tpu.runner import KERNELS as JKERNELS

    # every kernel of the JAX runner's mixture registry has its port
    assert set(JKERNELS) - set(KERNELS) == set()
