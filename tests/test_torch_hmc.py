"""The port's HMC / NUTS (`kernels/hmc.py`) against the JAX package.

Deterministic pieces get the same numpy inputs on both sides in float64
(`jax.enable_x64`), with the tolerance stated at each assert: the
bijectors and their log-dets, the checkpoint indices of the iterative
U-turn test (and the recursive-span check of tests/test_hmc.py:34), a
leapfrog trajectory, dual averaging and Welford sequences, and the hyper
target of `hp` (value and gradient) on a mixed niw + gp + bb state.

The samplers cannot match JAX draw for draw (threefry and Philox streams
differ), so they pass the distribution tests of tests/test_hmc.py:64-240:
standard-normal KS, correlated-Gaussian moments, fixed-length HMC on a
Gamma target, dual averaging's acceptance, `hp` against quadrature,
`theta` against the Beta conditional, `cluster_hp`'s concentration and
NIW's gradient path. The chains run in float64 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from common_tpu import scalar_functions as jsf
from common_tpu import state as jst
from common_tpu.kernels import hmc as jhmc
from common_tpu_torch import convert, models, rng
from common_tpu_torch import scalar_functions as sf
from common_tpu_torch import state as st
from common_tpu_torch.kernels import hmc
from common_tpu_torch.runner import KERNELS, runner

torch.set_num_threads(2)

F64 = dict(rtol=1e-12, atol=1e-12)


def _gen(seed):
    return rng(seed, "cpu").generator


def _f64(a):
    return torch.tensor(np.asarray(a, np.float64))


# ---------------------------------------------------------------------------
# deterministic pieces against JAX
# ---------------------------------------------------------------------------
SPECS = [hmc.IDENTITY, hmc.POSITIVE, hmc.lower_bounded(1.5), hmc.interval(-2.0, 3.0)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s[0])
def test_bijectors_and_log_dets_match_jax(spec):
    """Forward value and log-det to 1e-12; the inverse round-trips."""
    u = np.random.default_rng(0).normal(size=5)
    x, ld = hmc.bij_forward(spec, _f64(u))
    with jax.enable_x64(True):
        jx, jld = jhmc.bij_forward(spec, jnp.asarray(u))
        jx, jld = np.asarray(jx), float(jld)
    np.testing.assert_allclose(x.numpy(), jx, **F64)
    np.testing.assert_allclose(float(ld), jld, **F64)
    np.testing.assert_allclose(hmc.bij_inverse(spec, x).numpy(), u, rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError, match="unknown bijector"):
        hmc.bij_forward(("nope",), _f64(u))


def _recursive_spans(n):
    """tests/test_hmc.py:19-31: the complete-binary-subtree spans [m, n] the
    recursive algorithm checks when leaf n (odd) completes."""
    spans, k = [], 1
    while True:
        m = n - 2 ** k + 1
        if m < 0 or (m % (2 ** k)) != 0:
            break
        spans.append((m, n))
        k += 1
    return spans


def test_ckpt_indices_match_jax_and_the_recursive_spans():
    """For n < 64 the indices equal JAX's, and the checkpoint protocol with
    momenta p_i = 2^i (unique subset sums) addresses exactly the recursive
    spans (tests/test_hmc.py:34-61)."""
    max_n = 64
    p = 2.0 ** np.arange(max_n)
    csum = np.cumsum(p)
    p_ck, ps_ck = np.zeros(20), np.zeros(20)
    for n in range(max_n):
        idx_min, idx_max = hmc._leaf_to_ckpt_idxs(n)
        want = tuple(int(v) for v in jhmc._leaf_to_ckpt_idxs(jnp.int32(n)))
        assert (idx_min, idx_max) == want, n
        if n % 2 == 0:
            p_ck[idx_max], ps_ck[idx_max] = p[n], csum[n]
        else:
            spans = _recursive_spans(n)
            assert idx_max - idx_min + 1 == len(spans), (n, idx_min, idx_max)
            for j, (m, _) in enumerate(sorted(spans)):
                i = idx_min + j
                assert csum[n] - ps_ck[i] + p_ck[i] == p[m:n + 1].sum(), (n, m, i)
                assert p_ck[i] == p[m], (n, m, i)


def _quartic(x, lib):
    return -0.25 * lib.sum(x ** 4) - 0.5 * lib.sum(x * x) + lib.sum(x[:-1] * x[1:])


def test_leapfrog_trajectory_matches_jax():
    """12 leapfrog steps on a non-Gaussian target, forwards and backwards,
    to 1e-11; the port's one-evaluation leaf gives the same trajectory."""
    r = np.random.default_rng(1)
    q0, p0, m_inv = r.normal(size=3), r.normal(size=3), r.uniform(0.5, 2.0, 3)
    vg = hmc.value_and_grad(lambda x: _quartic(x, torch))
    for eps in (0.1, -0.07):
        q, p = hmc.leapfrog(lambda x: vg(x)[1], _f64(q0), _f64(p0), eps, _f64(m_inv), 12)
        with jax.enable_x64(True):
            jq, jp = jhmc.leapfrog(jax.grad(lambda x: _quartic(x, jnp)), jnp.asarray(q0),
                                   jnp.asarray(p0), eps, jnp.asarray(m_inv), 12)
            jq, jp = np.asarray(jq), np.asarray(jp)
        np.testing.assert_allclose(q.numpy(), jq, rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(p.numpy(), jp, rtol=1e-11, atol=1e-11)
        lq, lp, g = _f64(q0), _f64(p0), vg(_f64(q0))[1]
        for _ in range(12):
            lq, lp, _, g = hmc._leaf(vg, lq, lp, g, eps, _f64(m_inv))
        np.testing.assert_allclose(lq.numpy(), jq, rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(lp.numpy(), jp, rtol=1e-11, atol=1e-11)


def test_dual_averaging_and_welford_sequences_match_jax():
    """40 updates of each from one sequence of acceptances and draws, to
    1e-12. JAX's `da_init` casts the step size to float32, so the two
    starts agree to float32 rounding and the float64 sequences start from
    JAX's values."""
    r = np.random.default_rng(2)
    acc, xs = r.uniform(size=40), r.normal(size=(40, 3))
    wf = hmc.welford_init(3, dtype=torch.float64, device="cpu")
    with jax.enable_x64(True):
        jda, jwf = jhmc.da_init(0.3), jhmc.welford_init(3, jnp.float64)
        for got, want in zip(hmc.da_init(0.3, device="cpu"), jda):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-7)
        jda = jhmc.DAState(*(jnp.asarray(v, jnp.float64) for v in jda))
        da = hmc.DAState(*(torch.tensor(np.asarray(v)) for v in jda))
        for a, x in zip(acc, xs):
            da, jda = hmc.da_update(da, float(a)), jhmc.da_update(jda, float(a))
            wf, jwf = hmc.welford_update(wf, _f64(x)), jhmc.welford_update(jwf, jnp.asarray(x))
            for got, want in zip(da, jda):
                np.testing.assert_allclose(float(got), float(want), **F64)
        jvar = np.asarray(jhmc.welford_var(jwf))
    for got, want in zip(wf, jwf):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    np.testing.assert_allclose(hmc.welford_var(wf).numpy(), jvar, **F64)


def _jax_state(leaves):
    """A JAX MixtureState from numpy leaves (float64 kept under x64)."""
    arr = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    return jst.MixtureState(
        assignments=jnp.asarray(leaves["assignments"]), counts=jnp.asarray(leaves["counts"]),
        cluster_hp=arr(leaves["cluster_hp"]), stats=tuple(arr(s) for s in leaves["stats"]),
        hypers=tuple(arr(h) for h in leaves["hypers"]), lik_names=tuple(leaves["lik_names"]),
        fixed=leaves["fixed"])


def _mixed_state(n=80, k_max=6, seed=3):
    """A float64 niw(2) + gp + bb state with slot k_max - 1 empty."""
    r = np.random.default_rng(seed)
    z = r.integers(0, k_max - 1, n).astype(np.int32)
    X = r.normal(scale=2.0, size=(4, 2))[z % 4] + r.normal(size=(n, 2))
    data = ((_f64(X), torch.ones(n, dtype=torch.float64)),
            (_f64(r.poisson(np.exp(r.normal(size=k_max))[z])), torch.ones(n, dtype=torch.float64)),
            (_f64(r.random(n) < 0.3 + 0.1 * z), torch.ones(n, dtype=torch.float64)))
    defn = st.model_definition(n, [models.niw(2), models.gp, models.bb], k_max=k_max)
    hps = [{"mu0": np.zeros(2), "kappa": 0.7, "psi": np.eye(2), "nu": 4.0},
           {"alpha": 1.3, "inv_beta": 0.8}, {"alpha": 0.9, "beta": 1.6}]
    s = st.initialize(defn, data, _gen(0), cluster_hp={"alpha": 1.2}, feature_hps=hps, assignment=z)
    return defn, data, s


def _priors(lib_sf):
    exp1 = lib_sf.log_exponential(1.0)
    return {0: lambda h: lib_sf.log_exponential(0.1, field="kappa")(h)
            + lib_sf.log_exponential(0.05)({"nu": h["nu"] - 1.001}),
            1: lambda h: exp1(h["alpha"]) + exp1(h["inv_beta"]),
            2: lambda h: exp1(h["alpha"]) + exp1(h["beta"])}


def test_hyper_target_value_and_gradient_match_jax():
    """hp's target on a niw + gp + bb state, at the state's hypers and at a
    moved point, against JAX's `_make_hyper_target` and `jax.grad`: rtol
    1e-6 (both packages evaluate the Exp priors in float32, as
    `scalar_functions` casts there; everything else is float64)."""
    _, _, s = _mixed_state()
    transforms = {0: {"kappa": hmc.POSITIVE, "nu": hmc.lower_bounded(1.001)}}
    logprob, q0, unravel, tf = hmc.hyper_logprob(s, _priors(sf), transforms)
    assert {f: sorted(v) for f, v in tf.items()} == {0: ["kappa", "nu"], 1: ["alpha", "inv_beta"],
                                                     2: ["alpha", "beta"]}
    with jax.enable_x64(True):
        js = _jax_state(convert.state_to_numpy(s))
        jt = {f: dict(v) for f, v in tf.items()}
        target = jhmc._make_hyper_target(js, (0, 1, 2), _priors(jsf), jt)
        for shift in (0.0, 0.3):
            q = q0 + shift * torch.linspace(-1.0, 1.0, q0.shape[0], dtype=torch.float64)
            u = {f: {k: jnp.asarray(v.numpy()) for k, v in d.items()} for f, d in unravel(q).items()}
            jv, jg = jax.value_and_grad(target)(u)
            jg = np.concatenate([np.ravel(jg[f][k]) for f in sorted(jg) for k in sorted(jg[f])])
            v, g = hmc.value_and_grad(logprob)(q)
            np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)
            np.testing.assert_allclose(g.numpy(), jg, rtol=1e-6, atol=1e-9)
            assert np.isfinite(g.numpy()).all()


def test_every_expfam_marginal_is_finite_at_zero_counts_and_its_gradient_too():
    """The hyper target masks empty slots with `torch.where`; a non-finite
    marginal there would poison the gradient. At zero counts each
    conjugate likelihood's marginal is exactly 0 and its hyper gradient
    finite (0)."""
    from common_tpu_torch import likelihoods as tlik

    hypers = {"bb": {"alpha": 1.3, "beta": 0.7}, "bbv": {"alpha": [0.5, 1.5], "beta": [2.0, 1.0]},
              "dd": {"alphas": [0.5, 1.0, 2.0]}, "dm": {"alphas": [0.5, 1.0, 2.0]},
              "gp": {"alpha": 2.0, "inv_beta": 1.5},
              "nich": {"mu": 0.3, "kappa": 1.2, "sigmasq": 0.8, "nu": 2.0},
              "niw": {"mu0": [0.2, -0.4], "kappa": 1.7, "psi": [[1.2, 0.3], [0.3, 0.8]], "nu": 3.5}}
    for name, h in hypers.items():
        lik = tlik.get(name)
        hyper = {k: _f64(v).requires_grad_(True) for k, v in h.items()}
        ml = lik.marginal_loglik(hyper, lik.init_stats(hyper, (3,)))
        assert torch.equal(ml, torch.zeros(3, dtype=torch.float64)), name
        grads = torch.autograd.grad(ml.sum(), list(hyper.values()), allow_unused=True)
        assert all(g is None or bool(torch.isfinite(g).all()) for g in grads), name


# ---------------------------------------------------------------------------
# samplers: the distribution tests of tests/test_hmc.py
# ---------------------------------------------------------------------------
def test_nuts_standard_normal_ks():
    samples, info = hmc.sample(lambda x: -0.5 * (x * x).sum(), torch.zeros(1, dtype=torch.float64),
                               _gen(0), num_samples=2000, num_warmup=300)
    d, p = sps.kstest(samples[::4, 0].numpy(), "norm")
    assert p > 0.01, (d, p)
    assert not bool(info["diverging"].any())
    assert samples.shape == (2000, 1) and info["num_leaves"].shape == (2000,)


def test_nuts_correlated_gaussian_moments():
    cov = torch.tensor([[2.0, 1.2], [1.2, 1.0]], dtype=torch.float64)
    prec, mu = torch.linalg.inv(cov), torch.tensor([1.0, -2.0], dtype=torch.float64)
    samples, _ = hmc.sample(lambda x: -0.5 * (x - mu) @ prec @ (x - mu),
                            torch.zeros(2, dtype=torch.float64), _gen(1), num_samples=2000,
                            num_warmup=500)
    xs = samples.numpy()
    assert np.allclose(xs.mean(0), mu.numpy(), atol=0.15), xs.mean(0)
    assert np.allclose(np.cov(xs.T), cov.numpy(), atol=0.35), np.cov(xs.T)


def test_hmc_kernel_gamma_target():
    """Fixed-length HMC on log-Gamma(3, 2) (positivity by a log transform)."""
    a, rate = 3.0, 2.0
    samples, info = hmc.sample(lambda u: (a * u - rate * torch.exp(u)).sum(),
                               torch.zeros(1, dtype=torch.float64), _gen(2), num_samples=2000,
                               num_warmup=400, kernel="hmc", num_leapfrog=16)
    xs = np.exp(samples[:, 0].numpy())
    d, p = sps.kstest(xs[::4], sps.gamma(a, scale=1.0 / rate).cdf)
    assert p > 0.01, (d, p)
    assert float(info["accept_prob"].mean()) > 0.5


def test_dual_averaging_hits_target_accept():
    _, info = hmc.sample(lambda x: -0.5 * (x * x).sum(), torch.zeros(4, dtype=torch.float64),
                         _gen(3), num_samples=800, num_warmup=500, target_accept=0.8)
    acc = float(info["accept_prob"].mean())
    assert 0.6 < acc <= 1.0, acc


def test_sample_takes_a_dict_position():
    """A dict position comes back as a dict of stacked draws."""
    samples, _ = hmc.sample(lambda d: -0.5 * (d["a"] ** 2).sum() - 0.5 * (d["b"] ** 2).sum(),
                            {"a": torch.zeros(2, dtype=torch.float64),
                             "b": torch.zeros((), dtype=torch.float64)},
                            _gen(4), num_samples=50, num_warmup=20)
    assert samples["a"].shape == (50, 2) and samples["b"].shape == (50,)


def test_nuts_hp_matches_conjugate_posterior():
    """bb, one cluster, alpha under an Exp(0.5) prior: NUTS over alpha
    (beta held) against a fine-grid quadrature of the same posterior, mean
    within 0.35 posterior sd (tests/test_hmc.py:107-156)."""
    from scipy.special import betaln

    n = 30
    x = (np.random.default_rng(0).random(n) < 0.7).astype(np.float64)
    defn = st.model_definition(n, [models.bb], k_max=4)
    data = ((_f64(x), torch.ones(n, dtype=torch.float64)),)
    s = st.initialize(defn, data, _gen(0), assignment=np.zeros(n, np.int32),
                      feature_hps=[{"alpha": 1.0, "beta": 1.0}])
    prior = sf.log_exponential(0.5, field="alpha")
    g = _gen(5)
    alphas = []
    for _ in range(600):
        s = hmc.hp(s, data, g, priors={0: prior}, transforms={0: {"alpha": hmc.POSITIVE}},
                   step_size=0.3, num_steps=1)
        alphas.append(float(s.hypers[0]["alpha"]))
    alphas = np.array(alphas[100:])
    h, t = x.sum(), n - x.sum()
    grid = np.linspace(1e-3, 30, 20001)
    logp = -0.5 * grid + betaln(grid + h, 1.0 + t) - betaln(grid, 1.0)
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mean = (grid * w).sum()
    sd = np.sqrt(((grid - mean) ** 2 * w).sum())
    assert abs(alphas.mean() - mean) < 0.35 * sd, (alphas.mean(), mean, sd)
    assert s.hypers[0]["beta"].item() == 1.0


def test_nuts_theta_matches_exact_conditional():
    """bbnc latents through the runner's nuts_theta against the Beta
    posterior of each cluster (KS, tests/test_hmc.py:159-181)."""
    n = 6
    defn = st.model_definition(n, [models.bbnc], k_max=4)
    data = ((torch.tensor([1, 1, 1, 0, 1, 0]), torch.ones(n, dtype=torch.float64)),)
    s = st.initialize(defn, (( data[0][0].double(), data[0][1]),), _gen(0),
                      assignment=np.array([0, 0, 0, 1, 1, 1], np.int32))
    g = _gen(6)
    ps = []
    kernel = KERNELS["nuts_theta"]
    for _ in range(600):
        s = kernel(s, data, g, step_size=0.25, num_steps=2)
        ps.append(s.stats[0]["p"][:2].numpy().copy())
    ps = np.array(ps[100:])
    _, p0 = sps.kstest(ps[::4, 0], sps.beta(4, 1).cdf)
    _, p1 = sps.kstest(ps[::4, 1], sps.beta(2, 3).cdf)
    assert p0 > 0.01 and p1 > 0.01, (p0, p1)


def test_nuts_cluster_hp_moves_and_concentrates():
    """Many singleton clusters pull alpha up against few (tests/test_hmc.py:184-208)."""
    n = 12
    defn = st.model_definition(n, [models.bb], k_max=16)
    data = ((torch.zeros(n, dtype=torch.float64), torch.ones(n, dtype=torch.float64)),)
    prior = sf.log_exponential(1.0)

    def mean_alpha(assignment, seed):
        s = st.initialize(defn, data, _gen(seed), assignment=assignment, cluster_hp={"alpha": 1.0})
        g, alphas = _gen(seed), []
        for _ in range(800):
            s = hmc.cluster_hp(s, g, prior, step_size=0.4, num_steps=1)
            alphas.append(float(s.cluster_hp["alpha"]))
        return np.mean(alphas[200:])

    many = mean_alpha(np.arange(n, dtype=np.int32) % 12, 7)
    few = mean_alpha(np.zeros(n, np.int32), 8)
    assert many > 2.0 * few, (many, few)


def test_nuts_hp_niw_gradient_path():
    """NIW's (kappa, nu) under NUTS: it runs, stays in support and moves
    (tests/test_hmc.py:211-240)."""
    n, d = 40, 3
    X = np.random.default_rng(1).normal(size=(n, d))
    defn = st.model_definition(n, [models.niw(d)], k_max=4)
    data = ((_f64(X), torch.ones(n, dtype=torch.float64)),)
    s = st.initialize(defn, data, _gen(0), assignment=(np.arange(n) % 2).astype(np.int32))
    priors = {0: lambda h: sf.log_exponential(0.1, field="kappa")(h)
              + sf.log_exponential(0.05)({"nu": h["nu"] - (d - 1 + 1e-3)})}
    transforms = {0: {"kappa": hmc.POSITIVE, "nu": hmc.lower_bounded(d - 1 + 1e-3)}}
    g = _gen(9)
    for _ in range(10):
        s = hmc.hp(s, data, g, priors=priors, transforms=transforms, step_size=0.1, num_steps=2)
    kappa, nu = float(s.hypers[0]["kappa"]), float(s.hypers[0]["nu"])
    assert kappa > 0 and np.isfinite(kappa)
    assert nu > d - 1 and np.isfinite(nu)
    assert kappa != 1.0


def test_runner_takes_the_jax_runners_nuts_keywords():
    """nuts_hp (priors, transforms, step_size, num_steps, max_depth),
    nuts_cluster_hp (prior, ...) and nuts_theta run through the runner
    with the JAX runner's keywords (common_tpu/runner.py:83-98), and leave
    the assignments and stats alone."""
    defn, data, s = _mixed_state(n=40, k_max=5, seed=4)
    config = [("nuts_hp", {"priors": _priors(sf), "step_size": 0.05, "num_steps": 2, "max_depth": 4,
                           "transforms": {0: {"kappa": hmc.POSITIVE,
                                              "nu": hmc.lower_bounded(1.001)}}}),
              ("nuts_cluster_hp", {"prior": sf.log_exponential(1.0), "step_size": 0.1,
                                   "num_steps": 2, "max_depth": 4}),
              ("nuts_theta", {"step_size": 0.1, "num_steps": 1, "max_depth": 3})]
    run = runner(defn, data, s, config)
    run.run(_gen(1), 3)
    out = run.get_latent()
    assert torch.equal(out.assignments, s.assignments)
    for a, b in zip(out.stats, s.stats):
        assert all(torch.equal(a[k], b[k]) for k in b)
    moved = [float(out.hypers[f][k]) != float(s.hypers[f][k]) for f, k in
             ((0, "kappa"), (1, "alpha"), (2, "beta"))]
    assert all(moved) and float(out.cluster_hp["alpha"]) != 1.2
    assert np.isfinite(run.score_trace).all()
