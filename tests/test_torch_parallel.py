"""The port's (chains x data) mesh, data-sharded sweep and row-scaling
harness (`common_tpu_torch/parallel/`) against the JAX package.

Ranks are CPU processes over gloo, spawned with `torch.multiprocessing`
and joined through a FileStore under tmp_path (`torch_dist_workers.py`,
which imports no JAX). The checks of tests/test_parallel.py: counts and
stats of (1 x 2), (2 x 1) and (2 x 2) meshes equal the restat of the
all-gathered z (the port's own restat at rtol 1e-5, atol 1e-5: fp32 sums in
another order; JAX's at rtol 1e-4, atol 1e-4 as there); the sweep is
deterministic given the seeds; chains are independent; the 2 x 2 sampler
matches the exact partition posterior (KL 0.03); the reduction of float64
stats over 2 ranks equals JAX's `stats_from_assignments` at rtol 1e-9; the
scaling harness measures; at two data ranks each rank draws only its own
rows' [N_local, K] Gumbel noise, from a stream of its own, and the ranks'
chain generators stay in step. One process: at world size 1 the sharded
sweep equals `blocked.sweep` (bb) and `blocked.sweep_fused` (niw; the
kernels' plain versions on the CPU) bit for bit, `rng.shard_generator`
derives distinct, reproducible streams, and `init_distributed` keeps the
JAX failure policy.
"""

import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_workers as W
from common_tpu import models as jmodels
from common_tpu import state as jst
from common_tpu import testutil
from common_tpu.likelihoods import niw as jniw
from common_tpu_torch import models
from common_tpu_torch import state as st
from common_tpu_torch.kernels import blocked
from common_tpu_torch.ops import gaussian_assign as ga
from common_tpu_torch.parallel import mesh as mesh_mod
from common_tpu_torch.parallel import sharded, unstack_state
from common_tpu_torch.parallel.scaling import measure_row_scaling

from test_gibbs_exact import exact_partition_posterior

torch.set_num_threads(2)


def _f64_rows():
    r = np.random.default_rng(5)
    return r.normal(size=(24, 3)), r.integers(0, 8, size=24)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_sharded_sweep_counts_stats_determinism_and_chains(tmp_path, shape):
    out = str(tmp_path / "mesh")
    x64, z64 = _f64_rows()
    W.spawn(W.mesh_checks, shape[0] * shape[1], tmp_path, shape, out, x64, z64)
    res = {}
    for rank in range(shape[0] * shape[1]):
        res.update(dict(np.load(f"{out}.{rank}.npz")))
    n, C, K = 32, 4, 8
    defn, data = W.niw_problem(n, k_max=K, seed=1)
    x = data[0][0].numpy()
    hyp = {k: jnp.asarray(v) for k, v in jmodels.niw(2).canonical_hyper().items()}
    for c in range(C):
        z = res[f"z0_{c}"]
        assert z.shape == (n,)
        np.testing.assert_array_equal(res[f"counts_{c}"], np.bincount(z, minlength=K))
        s = unstack_state(W.chain_states(defn, data, C, 0), c)
        plain = blocked.restat(s, data, torch.from_numpy(z))
        want = jniw.stats_from_assignments(hyp, jnp.asarray(x), jnp.ones(n), jnp.asarray(z), K)
        for leaf in ("n", "sum_x", "sum_xxT"):
            got = res[f"stats_{c}_{leaf}"]
            np.testing.assert_allclose(got, plain.stats[0][leaf].numpy(), rtol=1e-5, atol=1e-5, err_msg=leaf)
            np.testing.assert_allclose(got, np.asarray(want[leaf]), rtol=1e-4, atol=1e-4, err_msg=leaf)
        # deterministic: the same sweeps from the same seeds give the same z
        np.testing.assert_array_equal(z, res[f"z1_{c}"])
    # independent chains: not all four trajectories alike
    zs = [res[f"z0_{c}"] for c in range(C)]
    assert any(not np.array_equal(zs[0], zc) for zc in zs[1:])
    # float64 stats of a fixed z reduced over the data ranks, against JAX in float64
    with jax.enable_x64(True):
        hyp64 = {k: jnp.asarray(v, jnp.float64) for k, v in jmodels.niw(3).canonical_hyper().items()}
        want = jniw.stats_from_assignments(hyp64, jnp.asarray(x64), jnp.ones(len(x64), jnp.float64),
                                           jnp.asarray(z64), 8)
        for leaf in ("n", "sum_x", "sum_xxT"):
            np.testing.assert_allclose(res[f"f64_{leaf}"], np.asarray(want[leaf]), rtol=1e-9, atol=1e-12,
                                       err_msg=leaf)


def test_sharded_sampler_matches_enumeration(tmp_path):
    """tests/test_parallel.py:87 on a 2 x 2 mesh: bb, n = 4, k_max = 16,
    the pooled samples of 4 chains against the exact partition posterior."""
    n, shape, burnin = 4, (2, 2), 300
    x = np.random.default_rng(4).integers(0, 2, size=n)
    exact = exact_partition_posterior(jst.model_definition(n, [jmodels.bb], k_max=5),
                                      ((jnp.asarray(x), jnp.ones(n)),), {"alpha": 1.0})
    cache = {}

    def sample_fn(nsamples):
        if nsamples not in cache:
            out = str(tmp_path / f"oracle{len(cache)}")
            W.spawn(W.oracle_samples, 4, tmp_path, shape, out, x, -(-nsamples // 4), burnin)
            cache[nsamples] = [testutil.permutation_canonical(z) for z in W.assemble_trace(out, shape)]
        return cache[nsamples]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=6000, ntries=3, kl_tol=0.03)


def test_each_data_rank_draws_only_its_rows_noise(tmp_path):
    """At two data ranks the plain route (bb) and the niw fallback draw
    [n_local, K] Gumbel noise a sweep, from the rank's own stream, never the
    whole [N, K] table and never from the chain's generator; the two ranks'
    noise differs, and their chain generators end in the same state."""
    out = str(tmp_path / "noise")
    W.spawn(W.noise_checks, 2, tmp_path, out)
    res = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(2)]
    for lik in ("bb", "niw"):
        for r in res:
            np.testing.assert_array_equal(r[f"{lik}_stream_shapes"], [[20, 8]] * 3)
            assert int(r[f"{lik}_chain_draws"]) == 0
        assert not np.array_equal(res[0][f"{lik}_first_noise"], res[1][f"{lik}_first_noise"])
        np.testing.assert_array_equal(res[0][f"{lik}_gen_state"], res[1][f"{lik}_gen_state"])


def test_shard_generator_streams():
    """rng.shard_generator: the same parent state and shard give the same
    stream; other shards and the parent's own stream differ; the parent
    advances by the same amount whatever the shard; a negative shard is
    refused."""
    from common_tpu_torch.rng import shard_generator

    parents = [torch.Generator().manual_seed(5) for _ in range(3)]
    streams = [shard_generator(p, i) for p, i in zip(parents, (0, 0, 1))]
    draws = [torch.rand(64, generator=g) for g in streams]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert torch.equal(parents[0].get_state(), parents[2].get_state())
    assert not torch.equal(torch.rand(64, generator=parents[0]), draws[0])
    again = shard_generator(parents[1], 0)  # the parent moved on: a new stream
    assert not torch.equal(torch.rand(64, generator=again), draws[0])
    with pytest.raises(ValueError, match="shard"):
        shard_generator(parents[2], -1)


@pytest.mark.parametrize("lik", ["niw", "bb"])
def test_world_size_one_equals_the_one_device_sweep(lik):
    """At world size 1 the all_reduce is the identity and the offset 0: the
    sharded sweep equals sweep_fused (niw) or sweep (bb) bit for bit."""
    r = np.random.default_rng(3)
    n = 40
    if lik == "niw":
        desc, x, ref = models.niw(2), torch.from_numpy(r.normal(size=(n, 2)).astype(np.float32)), blocked.sweep_fused
    else:
        desc, x, ref = models.bb, torch.from_numpy(r.integers(0, 2, size=n)), blocked.sweep
    defn = st.model_definition(n, [desc], k_max=8)
    mask = torch.from_numpy((r.random(n) > 0.1).astype(np.float32))
    data = ((x, mask),)
    one = st.initialize(defn, data, torch.Generator().manual_seed(1), cluster_hp={"alpha": 1.0})
    with W.one_process_group() as mesh:
        states, local = mesh_mod.shard_state(
            mesh, sharded.initialize_chains(defn, data, [torch.Generator().manual_seed(1)],
                                            cluster_hp={"alpha": 1.0}), data)
        sweep = sharded.make_sharded_sweep(mesh, states, local)
        g_sharded, g_one = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
        for _ in range(4):
            states = sweep(states, local, [g_sharded])
            one = ref(one, data, g_one)
            got = unstack_state(states, 0)
            assert torch.equal(got.assignments, one.assignments)
            assert torch.equal(got.counts, one.counts)
            for leaf, v in one.stats[0].items():
                assert torch.equal(got.stats[0][leaf], v), leaf
        assert torch.equal(g_sharded.get_state(), g_one.get_state())


def test_row_offset_draws_the_whole_rows_noise():
    """Kernel 1's plain version (the CPU route): two row shards with their
    offsets draw exactly the z of one call over all rows; a negative offset
    is refused."""
    r = np.random.default_rng(8)
    n, d, k = 50, 3, 4
    X = torch.from_numpy(r.normal(size=(n, d)).astype(np.float32))
    mu = torch.from_numpy(r.normal(size=(k, d)).astype(np.float32))
    binv = torch.eye(d).expand(k, d, d).contiguous()
    base = torch.zeros(k)
    seed = torch.tensor([4], dtype=torch.int32)
    whole = ga.fused_gaussian_assign(X, mu, binv, base, seed)
    parts = torch.cat([ga.fused_gaussian_assign(X[:20], mu, binv, base, seed),
                       ga.fused_gaussian_assign(X[20:], mu, binv, base, seed, row_offset=20)])
    assert torch.equal(parts, whole)
    with pytest.raises(ValueError, match="row_offset"):
        ga.fused_gaussian_assign(X, mu, binv, base, seed, row_offset=-1)


def test_gumbel_rows_of_the_whole_table():
    """rng.gumbel_argmax_rows, the noise of kernel 1's plain version with a
    row_offset: at row 0 of n rows it is gumbel_argmax bit for bit, and
    row shards of n_total draw the whole call's z and leave every shard's
    generator where the whole call leaves it; rows outside n_total raise."""
    from common_tpu_torch.rng import gumbel_argmax, gumbel_argmax_rows

    logits = torch.from_numpy(np.random.default_rng(9).normal(size=(30, 5)).astype(np.float32))
    g = [torch.Generator().manual_seed(3) for _ in range(4)]
    assert torch.equal(gumbel_argmax_rows(logits, g[0]), gumbel_argmax(logits, g[1]))
    whole = gumbel_argmax_rows(logits, g[2], 0, 30)
    parts = [gumbel_argmax_rows(logits[a:b], torch.Generator().manual_seed(3), a, 30)
             for a, b in ((0, 12), (12, 30))]
    assert torch.equal(torch.cat(parts), whole)
    h = torch.Generator().manual_seed(3)
    gumbel_argmax_rows(logits[12:], h, 12, 30)
    assert torch.equal(h.get_state(), g[2].get_state())
    with pytest.raises(ValueError, match="outside"):
        gumbel_argmax_rows(logits, g[3], 5, 30)


def test_mesh_layout_and_refusals():
    with W.one_process_group() as mesh:
        assert (mesh.shape, mesh.chain_index, mesh.data_index, mesh.rank) == ((1, 1), 0, 0, 0)
        assert mesh.axis_names == (mesh_mod.CHAINS, mesh_mod.DATA) == ("chains", "data")
        assert mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match="needs 2 processes"):
            mesh_mod.make_mesh(1, 2, backend="gloo", device="cpu")
        with pytest.raises(ValueError, match="not 'nccl'"):
            mesh_mod.make_mesh(1, 1, backend="nccl")
        with pytest.raises(ValueError, match="backend named"):
            mesh_mod.make_mesh(1, 1)
    # placement: a (2 x 2) mesh's rank 3 keeps chains 2-3 and rows 5-9 of 10
    fake = mesh_mod.Mesh((2, 2), 1, 1, None, torch.device("cpu"))
    defn, data = W.niw_problem(10)
    states = W.chain_states(defn, data, 4, 0)
    local, cols = mesh_mod.shard_state(fake, states, data)
    assert torch.equal(local.assignments, states.assignments[2:4, 5:10])
    assert torch.equal(local.stats[0]["sum_xxT"], states.stats[0]["sum_xxT"][2:4])
    assert torch.equal(cols[0][0], data[0][0][5:10])
    assert mesh_mod.state_pspec(states)["assignments"] == ("chains", "data")
    assert mesh_mod.data_pspec(data) == ((("data",), ("data",)),)
    with pytest.raises(ValueError, match="must divide"):
        mesh_mod.shard_state(fake, W.chain_states(*W.niw_problem(9), 4, 0), W.niw_problem(9)[1])


def test_init_distributed_failure_policy(monkeypatch):
    """tests/test_parallel.py:207: an init failure degrades to one process
    (with a warning) only when no distributed job is detectable."""
    calls = []

    def boom(backend, init_method=None, world_size=-1, rank=-1, store=None, **kw):
        calls.append(store)
        if store is None:
            raise RuntimeError("rendezvous unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    for marker in mesh_mod._DIST_ENV_MARKERS + ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(marker, raising=False)

    # nothing detectable: a warning and a one-process group over an in-memory store
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert mesh_mod.init_distributed("gloo") == 0
    assert any("single-process" in str(x.message) for x in w)
    assert calls[-1] is not None
    # explicit arguments re-raise
    with pytest.raises(RuntimeError, match="rendezvous unreachable"):
        mesh_mod.init_distributed("gloo", world_size=4, rank=0)
    with pytest.raises(RuntimeError):
        mesh_mod.init_distributed("gloo", init_method="tcp://10.0.0.1:29500")
    # torchrun's environment re-raises
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError):
        mesh_mod.init_distributed("gloo")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("TORCHELASTIC_RUN_ID", "job")
    with pytest.raises(RuntimeError):
        mesh_mod.init_distributed("gloo")
    # an unknown backend is refused before any init
    with pytest.raises(ValueError):
        mesh_mod.init_distributed("mpi")
    # already initialised: the rank, no init
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    n = len(calls)
    assert mesh_mod.init_distributed("gloo", world_size=4) == 0 and len(calls) == n


def test_spawn_fails_on_a_failed_or_hung_rank():
    """`mesh.spawn` raises when a rank raises, and kills ranks still running
    past its timeout."""
    with pytest.raises(Exception, match="rank 1 failed"):
        mesh_mod.spawn(W.sleeper, (60.0, 1), 2, timeout_s=60.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        mesh_mod.spawn(W.sleeper, (60.0, -1), 2, timeout_s=1.0)
    assert time.monotonic() - t0 < 30.0


def test_scaling_harness_measures():
    """tests/test_parallel.py:137 at shard counts (1, 2) on CPU processes:
    every key, positive rates, the collectives ran (a plumbing check)."""
    res = measure_row_scaling(n=1001, d=4, k_max=8, sweeps=2, shard_counts=(2, 1),
                              devices=["cpu", "cpu"], backend="gloo", repeats=2)
    for key in ("throughput", "spread", "efficiency", "collectives_ok", "shard_counts", "n", "d",
                "k_max", "sweeps", "repeats"):
        assert key in res, key
    assert res["shard_counts"] == [1, 2] and res["n"] == 1002
    assert all(v > 0 for v in res["throughput"].values()), res
    assert 0 < res["efficiency"] < 100 and res["collectives_ok"] is True, res
    with pytest.raises(ValueError, match="devices"):
        measure_row_scaling(shard_counts=(1, 2), devices=["cpu"], backend="gloo")
