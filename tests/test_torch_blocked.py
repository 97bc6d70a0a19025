"""The port's blocked Gibbs sweeps and runner.

Samplers cannot match the JAX package draw for draw, so the port's sweeps
are held to the same exact-enumeration oracle as `tests/test_blocked.py`
(the exact posterior scored by the JAX package), and its runner to the
recovery bar the JAX path meets. On the CPU the fused sweep runs the
kernels' plain versions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common_tpu import models as jmodels
from common_tpu import state as jst
from common_tpu import testutil
from common_tpu_torch import models, rng
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked
from common_tpu_torch.runner import run_chain, runner

from test_gibbs_exact import exact_partition_posterior

torch.set_num_threads(2)


@pytest.mark.parametrize("kernel", ["assign_blocked", "assign_blocked_fused"])
def test_sweep_matches_enumeration(kernel):
    r = np.random.default_rng(2)
    n = 4
    X = r.normal(size=(n, 2)).astype(np.float32)
    chp = {"alpha": 1.5}
    exact = exact_partition_posterior(
        jst.model_definition(n, [jmodels.niw(2)], k_max=5),
        ((jnp.asarray(X), jnp.ones(n)),), chp,
    )
    defn = st.model_definition(n, [models.niw(2)], k_max=16)
    data = ((torch.from_numpy(X), torch.ones(n)),)
    cache = {}

    def sample_fn(nsweeps):
        if nsweeps not in cache:
            seed = len(cache)
            s0 = st.initialize(defn, data, rng(seed + 100, "cpu").generator, cluster_hp=chp)
            _, trace = run_chain(s0, data, rng(seed, "cpu").generator, nsweeps + 300, [kernel])
            zs = trace["assignments"][300:].numpy()
            cache[nsweeps] = [testutil.permutation_canonical(a) for a in zs]
        return cache[nsweeps]

    testutil.assert_discrete_dist_approx(
        sample_fn, exact, nsamples=6000, ntries=3, kl_tol=0.03
    )


def _recovery_problem():
    r = np.random.default_rng(0)
    centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    zt = r.integers(0, 3, 600)
    X = centers[zt] + r.normal(scale=0.6, size=(600, 2))
    defn = st.model_definition(600, [models.niw(2)], k_max=32)
    data = ((torch.tensor(X, dtype=torch.float32), torch.ones(600)),)
    return defn, data, zt


def test_runner_fused_recovers_clusters():
    defn, data, zt = _recovery_problem()
    s = st.initialize(defn, data, rng(42, "cpu").generator, cluster_hp={"alpha": 1.0})
    run = runner(defn, data, s, [("assign_blocked_fused", {})])
    run.run(rng(1, "cpu").generator, 40)
    run.run(rng(2, "cpu").generator, 20)
    zs = run.assignment_trace
    assert zs.shape == (60, 600) and run.score_trace.shape == (60,)
    assert run.k_active_trace.shape == (60,)
    co = np.mean([a[:, None] == a[None, :] for a in zs[-20:]], axis=0) > 0.5
    assert (co == (zt[:, None] == zt[None, :])).mean() > 0.95
    assert np.isfinite(run.score_trace).all()
    assert int(run.get_latent().counts.sum()) == 600


@pytest.mark.parametrize("case", ["masked", "fixed_k", "k_max_1", "all_masked"])
@pytest.mark.parametrize("sweep", [blocked.sweep, blocked.sweep_fused])
def test_sweeps_stay_finite(case, sweep):
    defn, data, _ = _recovery_problem()
    x, mask = data[0]
    mask = mask.clone()
    mask[:100] = 0.0
    fixed, k_max = case == "fixed_k", {"fixed_k": 5, "k_max_1": 1}.get(case, 32)
    if case == "all_masked":
        mask.zero_()
    defn = st.model_definition(600, [models.niw(2)], k_max=k_max)
    data = ((x, mask),)
    g = rng(7, "cpu").generator
    s = st.initialize(defn, data, g, fixed=fixed)
    for _ in range(3):
        s = sweep(s, data, g)
        assert np.isfinite(float(st.score_joint(s)))
    assert int(s.counts.sum()) == 600
    assert float(s.stats[0]["n"].sum()) == float(mask.sum())
    if case == "all_masked":
        assert float(s.stats[0]["sum_xxT"].abs().sum()) == 0.0


def test_fused_stats_equal_the_plain_restat_of_its_draw():
    defn, data, _ = _recovery_problem()
    x, mask = data[0]
    mask = mask.clone()
    mask[::7] = 0.0
    data = ((x, mask),)
    s = st.initialize(defn, data, rng(3, "cpu").generator)
    out = blocked.sweep_fused(s, data, rng(4, "cpu").generator)
    plain = blocked.restat(s, data, out.assignments)
    assert torch.equal(out.counts, plain.counts)
    for leaf in ("n", "sum_x", "sum_xxT"):
        torch.testing.assert_close(out.stats[0][leaf], plain.stats[0][leaf], rtol=1e-5, atol=1e-4)


def test_stick_break_weights_normalize_and_order():
    counts = torch.tensor([5, 3, 0, 2, 0, 0, 0, 0], dtype=torch.int32)
    g = rng(0, "cpu").generator
    alpha = torch.tensor(1.0)
    logw = blocked.stick_break_log_weights(g, counts, alpha)
    torch.testing.assert_close(torch.logsumexp(logw, 0), torch.tensor(0.0), atol=1e-5, rtol=0)
    many = torch.stack([blocked.stick_break_log_weights(g, counts, alpha) for _ in range(512)])
    mean_w = many.exp().mean(0)
    assert mean_w[0] > mean_w[1] > mean_w[3]
    single = blocked.stick_break_log_weights(g, torch.tensor([4], dtype=torch.int32), alpha)
    assert single.tolist() == [0.0]


def test_dirichlet_weights_mean():
    counts = torch.tensor([6, 0, 2], dtype=torch.int32)
    alphas = torch.tensor([1.0, 1.0, 2.0])
    g = rng(1, "cpu").generator
    w = torch.stack([blocked.dirichlet_log_weights(g, counts, alphas) for _ in range(4000)]).exp()
    want = (alphas + counts) / (alphas + counts).sum()
    torch.testing.assert_close(w.mean(0), want, atol=0.01, rtol=0)


def test_sweep_fused_rejects_other_models():
    """bbv now runs through sweep_fused (the linear assignment kernel's plain
    version on the CPU); any model other than a single niw or bbv raises."""
    defn, data, _ = _recovery_problem()
    s = st.initialize(defn, data, rng(0, "cpu").generator)
    g = rng(1, "cpu").generator
    B = (data[0][0] > 0).to(torch.float32)
    bdata = ((B, torch.ones(600)),)
    sb = st.initialize(st.model_definition(600, [models.bbv(2)], k_max=32), bdata, g)
    out = blocked.sweep_fused(sb, bdata, g)
    assert out.lik_names == ("bbv",) and int(out.counts.sum()) == 600
    with pytest.raises(ValueError, match="single niw or bbv"):
        blocked.sweep_fused(dataclasses.replace(s, lik_names=("niw", "niw")), data, g)


def test_runner_rejects_unknown_kernels():
    defn, data, _ = _recovery_problem()
    s = st.initialize(defn, data, rng(0, "cpu").generator)
    with pytest.raises(ValueError, match="kernel name"):
        runner(defn, data, s, [("nuts_hpp", {})])  # a kernel of neither runner
    with pytest.raises(ValueError, match="kernel name"):
        runner(defn, data, s, ["assign_blocked_fusd"])
    with pytest.raises(TypeError):
        runner(defn, data, object(), ["assign_blocked"])


@pytest.mark.parametrize("config", [[("assign_blocked_fused", {"fused_restat": False})],
                                    [("assign_blocked_fused", {"k_tile": 24, "tile_n": 2048,
                                                               "interpret": True})],
                                    [("assign_blocked", {"m": 1})]])
def test_runner_takes_the_jax_runners_blocked_keywords(config):
    """The JAX runner's keywords for the blocked kernels run
    (common_tpu/runner.py:41-50): assign_blocked drops its keywords,
    assign_blocked_fused ignores the Pallas tiling knobs and honours
    fused_restat."""
    defn, data, _ = _recovery_problem()
    s = st.initialize(defn, data, rng(0, "cpu").generator)
    run = runner(defn, data, s, config)
    run.run(rng(1, "cpu").generator, 2)
    out = run.get_latent()
    assert int(out.counts.sum()) == defn.n and np.isfinite(run.score_trace).all()


def test_fused_restat_false_rebuilds_through_restat(monkeypatch):
    """fused_restat=False: the stats come from `blocked.restat` of the drawn
    z, and the suffstat kernel's wrapper is not called."""
    defn, data, _ = _recovery_problem()
    s = st.initialize(defn, data, rng(0, "cpu").generator)
    calls = []
    real_restat = blocked.restat
    monkeypatch.setattr(blocked, "restat", lambda *a, **k: calls.append(1) or real_restat(*a, **k))
    monkeypatch.setattr(blocked, "fused_scatter_stats", lambda *a, **k: pytest.fail("kernel called"))
    out = blocked.sweep_fused(s, data, rng(1, "cpu").generator, fused_restat=False)
    assert calls == [1]
    want = real_restat(out, data, out.assignments)
    assert torch.equal(out.counts, want.counts)
    for k, v in want.stats[0].items():
        assert torch.equal(out.stats[0][k], v)
