"""The port's subsample annealing (`common_tpu_torch/kernels/annealing.py`)
against the JAX package, as tests/test_annealing.py holds the JAX kernel.

The annealed chain must seat every row with intact CRP and suffstat
bookkeeping (counts equal a recount, stats a recompute, rtol = atol =
1e-4), recover planted clusters, honour a prefix start, and, once every
row is active, reduce to random-scan collapsed Gibbs, whose stationary law
is the exact posterior (the enumeration oracle).
`linear_schedule` equals the JAX function's output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common_tpu import models as jmodels
from common_tpu import state as jst
from common_tpu import testutil
from common_tpu.kernels import annealing as jannealing
from common_tpu_torch import models, rng
from common_tpu_torch import state as st
from common_tpu_torch.kernels import annealing

from test_gibbs_exact import exact_partition_posterior

torch.set_num_threads(2)


def _nich_problem(n, seed=0, k_max=8):
    r = np.random.default_rng(seed)
    x = np.concatenate([r.normal(-3, 0.5, n // 2), r.normal(3, 0.5, n - n // 2)]).astype(np.float32)
    defn = st.model_definition(n, [models.nich], k_max=k_max)
    return defn, ((torch.from_numpy(x), torch.ones(n)),), (x < 0).astype(int)


@pytest.mark.parametrize("n,n_init,add,res", [(60, 0, 7, 5), (200, 0, 8, 8), (24, 12, 1, 0),
                                              (10, 10, 4, 4), (10, 25, 3, 1), (10000, 0, 64, 64)])
def test_linear_schedule_matches_jax(n, n_init, add, res):
    want = jannealing.linear_schedule(n, n_init=n_init, add_per_step=add, resample_per_step=res)
    assert annealing.linear_schedule(n, n_init=n_init, add_per_step=add, resample_per_step=res) == want


def test_anneal_activates_all_rows_with_intact_bookkeeping():
    n = 60
    defn, data, _ = _nich_problem(n, seed=1)
    s0 = annealing.empty_state(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.0})
    assert int(s0.counts.sum()) == 0 and (s0.assignments == -1).all()
    n_steps, add, res = annealing.linear_schedule(n, add_per_step=7, resample_per_step=5)
    s = annealing.run(s0, data, rng(1, "cpu").generator, n_steps, add_per_step=add, resample_per_step=res)
    z = s.assignments.numpy()
    assert (z >= 0).all()
    np.testing.assert_array_equal(s.counts.numpy(), np.bincount(z, minlength=defn.k_max))
    fresh = st.compute_stats(defn, s.hypers, data, s.assignments)
    for got, want in zip(s.stats, fresh):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4)
    assert torch.isfinite(st.score_joint(s))
    assert (s0.assignments == -1).all()  # the input state is unchanged


def test_anneal_recovers_two_clusters():
    """+60 steps after activation: about 5 random-scan sweeps of burn-in."""
    n = 200
    defn, data, truth = _nich_problem(n, seed=2)
    s0 = annealing.empty_state(defn, data, rng(3, "cpu").generator, cluster_hp={"alpha": 1.0})
    n_steps, add, res = annealing.linear_schedule(n, add_per_step=8, resample_per_step=8)
    s = annealing.run(s0, data, rng(4, "cpu").generator, n_steps + 60, add_per_step=add, resample_per_step=res)
    z = s.assignments.numpy()
    assert np.bincount(z[truth == 1]).argmax() != np.bincount(z[truth == 0]).argmax()
    purity = sum(max((truth[z == k] == 1).sum(), (truth[z == k] == 0).sum()) for k in np.unique(z)) / n
    assert purity > 0.95, purity


def test_anneal_respects_prefix_initialization():
    """Rows assigned in the initial state count as active; the rest seat."""
    n = 24
    defn, data, _ = _nich_problem(n, seed=5)
    half = np.full(n, -1, np.int32)
    half[: n // 2] = np.arange(n // 2) % 3
    s0 = st.initialize(defn, data, rng(0, "cpu").generator, cluster_hp={"alpha": 1.0}, assignment=half)
    s = annealing.run(s0, data, rng(1, "cpu").generator, n_steps=n // 2, add_per_step=1, resample_per_step=0)
    assert (s.assignments >= 0).all()
    assert int(s.counts.sum()) == n
    # with no resample slots, the prefix rows keep their seats
    np.testing.assert_array_equal(s.assignments.numpy()[: n // 2], half[: n // 2])


def test_anneal_rejects_bad_schedules():
    defn, data, _ = _nich_problem(10)
    s0 = annealing.empty_state(defn, data, rng(0, "cpu").generator)
    for kw in ({"n_steps": 0}, {"n_steps": 2, "add_per_step": 0}, {"n_steps": 2, "resample_per_step": -1}):
        with pytest.raises(ValueError):
            annealing.run(s0, data, rng(1, "cpu").generator, **kw)


def test_random_scan_resample_matches_enumeration():
    """Fully-active annealing steps are random-scan collapsed Gibbs: the
    exact posterior is invariant (tests/test_annealing.py:113)."""
    x = np.random.default_rng(8).integers(0, 2, size=4)
    chp = {"alpha": 1.5}
    exact = exact_partition_posterior(jst.model_definition(4, [jmodels.bb], k_max=5),
                                      ((jnp.asarray(x), jnp.ones(4)),), chp)
    defn = st.model_definition(4, [models.bb], k_max=5)
    data = ((torch.from_numpy(x), torch.ones(4)),)
    cache = {}

    def sample_fn(nsamples):
        if nsamples not in cache:
            s = st.initialize(defn, data, rng(60, "cpu").generator, cluster_hp=chp)
            g = rng(9 + len(cache), "cpu").generator
            out = []
            for t in range(nsamples + 100):
                s = annealing.run(s, data, g, n_steps=2, add_per_step=1, resample_per_step=3)
                if t >= 100:
                    out.append(testutil.permutation_canonical(s.assignments.numpy()))
            cache[nsamples] = out
        return cache[nsamples]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=2500, ntries=3, kl_tol=0.02)
