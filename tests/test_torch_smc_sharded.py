"""The port's particle-sharded SMC (`common_tpu_torch/kernels/smc.py`
`run_sharded`, `run_blocked_sharded`) against the JAX package.

Two ranks are CPU processes over gloo (`torch_dist_workers.py`, which
imports no JAX). As tests/test_smc.py:111 and :318 hold the JAX sharded
runs: over 6 seeds of 256 particles, the log-mean-Z is within 0.15 of the
exact evidence (the JAX enumeration of every partition), with every row
seated in every particle. At world size 1 both equal the one-device runs
bit for bit (logz, log-weights, assignments); P that does not divide over
the ranks is refused.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp as sp_logsumexp

import torch_dist_workers as W
from common_tpu import models as jmodels
from common_tpu import state as jst
from common_tpu import testutil
from common_tpu_torch.kernels import smc
from common_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _exact_log_evidence(n, seed, k_max):
    """log p(data) of W.bb_problem's rows: logsumexp of the JAX score_joint
    over every partition."""
    x = np.random.default_rng(seed).integers(0, 2, size=n)
    defn = jst.model_definition(n, [jmodels.bb], k_max=k_max)
    data = ((jnp.asarray(x), jnp.ones(n)),)
    score = jax.jit(lambda a: jst.score_joint(jst.initialize(defn, data, jax.random.key(0),
                                                             cluster_hp={"alpha": 1.0}, assignment=a)))
    return sp_logsumexp([float(score(jnp.asarray(p, jnp.int32))) for p in testutil.permutation_iter(n)])


def test_sharded_smc_evidence_on_two_ranks(tmp_path):
    out = str(tmp_path / "smc")
    seeds = list(range(6))
    W.spawn(W.smc_runs, 2, tmp_path, out, 256, seeds)
    r0, r1 = (dict(np.load(f"{out}.{r}.npz")) for r in range(2))
    for kind, k_max in (("row", 7), ("blocked", 16)):
        np.testing.assert_array_equal(r0[f"{kind}_logz"], r1[f"{kind}_logz"])  # one logz on every rank
        assert r0[f"{kind}_seated"].all() and r1[f"{kind}_seated"].all(), kind
        logzs = r0[f"{kind}_logz"]
        log_mean_z = sp_logsumexp(logzs) - np.log(len(logzs))
        exact = _exact_log_evidence(6, 1, k_max)
        assert abs(log_mean_z - exact) < 0.15, (kind, log_mean_z, exact, logzs)


def _same(a: smc.SMCResult, b: smc.SMCResult):
    assert torch.equal(a.logz, b.logz)
    assert torch.equal(a.log_w, b.log_w)
    assert a.n_resamples == b.n_resamples
    assert torch.equal(a.ess_trace, b.ess_trace)
    for f in dataclasses.fields(a.particles):
        va, vb = getattr(a.particles, f.name), getattr(b.particles, f.name)
        if torch.is_tensor(va):
            assert torch.equal(va, vb), f.name
    for sa, sb in zip(a.particles.stats, b.particles.stats):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("kind", ["row", "blocked"])
def test_world_size_one_equals_the_one_device_runs(kind):
    """With one rank the gather and broadcast carry rank 0's own draws:
    run_sharded == run and run_blocked_sharded == run_blocked, bit for bit
    (rejuvenation on, blocks and warmup rows both taken; a high ESS
    threshold, so that both resample)."""
    n = 12
    defn, data = W.bb_problem(n, 2, 8)
    with W.one_process_group() as _:
        mesh = smc.make_particle_mesh("gloo", device="cpu")
        parts = smc.init_particles(defn, data, torch.Generator().manual_seed(0), 32, cluster_hp={"alpha": 1.0})
        local, sdata = smc.shard_particles(mesh, parts, data)
        g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        if kind == "row":
            a = smc.run_sharded(mesh, local, sdata, g1, ess_threshold=0.999, rejuvenation_moves=2)
            b = smc.run(parts, data, g2, ess_threshold=0.999, rejuvenation_moves=2)
        else:
            a = smc.run_blocked_sharded(mesh, local, sdata, g1, block=3, ess_threshold=0.999, warmup=4)
            b = smc.run_blocked(parts, data, g2, block=3, ess_threshold=0.999, warmup=4)
    assert b.n_resamples > 0
    _same(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_particles_must_divide_over_the_ranks():
    defn, data = W.bb_problem(6, 1, 7)
    parts = smc.init_particles(defn, data, torch.Generator().manual_seed(0), 5, cluster_hp={"alpha": 1.0})
    two = mesh_mod.Mesh((1, 2), 0, 1, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        smc.shard_particles(two, parts, data)
    local, _ = smc.shard_particles(two, smc.init_particles(defn, data, torch.Generator().manual_seed(0), 6,
                                                           cluster_hp={"alpha": 1.0}), data)
    assert local.counts.shape[0] == 3
    with pytest.raises(ValueError, match="1 x W"):
        smc.shard_particles(mesh_mod.Mesh((2, 1), 0, 0, None, torch.device("cpu")), parts, data)
