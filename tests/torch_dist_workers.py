"""Worker processes of the port's multi-process tests (gloo over CPU processes).

`tests/test_torch_parallel.py` and `tests/test_torch_smc_sharded.py` spawn
these with `torch.multiprocessing` (spawn method); each rank joins a
`FileStore` under the test's tmp_path, so no TCP port is taken. This module
imports neither JAX nor the JAX package: a spawned child imports it to
unpickle its target. Each worker runs several checks and writes what the
parent compares to `{out}.{rank}.npz`.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from common_tpu_torch import models
from common_tpu_torch import state as st
from common_tpu_torch.kernels import smc
from common_tpu_torch.parallel import mesh as mesh_mod
from common_tpu_torch.parallel import sharded


def spawn(fn, world: int, tmp, *args):
    """Run fn(rank, world, store, *args) in `world` spawned processes over a
    FileStore in tmp; a failed rank raises here, and one still running
    after 150 s is killed."""
    store = os.path.join(str(tmp), f"store_{fn.__name__}_{world}_{len(os.listdir(tmp))}")
    mesh_mod.spawn(fn, (world, store) + tuple(args), world, timeout_s=150.0)


def _join(rank, world, store):
    torch.set_num_threads(1)
    mesh_mod.init_distributed("gloo", init_method=f"file://{store}", world_size=world, rank=rank)


@contextlib.contextmanager
def one_process_group():
    """A one-process gloo group in this process, destroyed on exit."""
    with tempfile.TemporaryDirectory() as tmp:
        mesh_mod.init_distributed("gloo", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            yield mesh_mod.make_mesh(1, 1, backend="gloo", device="cpu")
        finally:
            dist.destroy_process_group()


def sleeper(rank, seconds, fail_rank):
    """A rank that sleeps, or raises if it is fail_rank."""
    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} failed")
    time.sleep(seconds)


# ---------------------------------------------------------------------------
# the sharded sweep
# ---------------------------------------------------------------------------
def niw_problem(n, d=2, k_max=8, seed=0):
    """tests/test_parallel.py's `_problem`: standard normal rows, one niw feature."""
    r = np.random.default_rng(seed)
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    return defn, ((torch.from_numpy(r.normal(size=(n, d)).astype(np.float32)), torch.ones(n)),)


def chain_states(defn, data, n_chains, seed):
    gens = [torch.Generator().manual_seed(sharded.chain_seed(seed, c)) for c in range(n_chains)]
    return sharded.initialize_chains(defn, data, gens, cluster_hp={"alpha": 1.0})


def mesh_checks(rank, world, store, shape, out, f64_x, f64_z):
    """On a `shape` mesh: 4 chains over 32 niw rows (2 sweeps); the chains
    gathered; the same sweeps again from the same seeds; and, over the data
    ranks, the all-reduced stats of f64 rows under a fixed z."""
    _join(rank, world, store)
    mesh = mesh_mod.make_mesh(*shape, backend="gloo", device="cpu")
    n, C = 32, 4
    defn, data = niw_problem(n, k_max=8, seed=1)
    res = {}
    for run in range(2):  # twice from the same seeds: the sweep is deterministic
        states, local = mesh_mod.shard_state(mesh, chain_states(defn, data, C, 0), data)
        sweep = sharded.make_sharded_sweep(mesh, states, local)
        gens = sharded.chain_generators(mesh, 7, C)
        for _ in range(2):
            states = sweep(states, local, gens)
        for i in range(states.counts.shape[0]):
            g = sharded.gather_chain(mesh, states, i)
            c = mesh.chain_index * states.counts.shape[0] + i
            res[f"z{run}_{c}"] = g.assignments.numpy()
            if run == 0:
                res[f"counts_{c}"] = g.counts.numpy()
                for k, v in g.stats[0].items():
                    res[f"stats_{c}_{k}"] = v.numpy()
    # the reduction against float64: fixed z, this rank's rows of f64 rows
    x = torch.from_numpy(f64_x)
    z = torch.from_numpy(f64_z)
    r0, r1 = mesh_mod.row_span(mesh, len(x))
    desc = models.niw(x.shape[1])
    hyper = desc.canonical_hyper(dtype=torch.float64, device="cpu")
    s = desc.likelihood.stats_from_assignments(hyper, x[r0:r1], torch.ones(r1 - r0, dtype=torch.float64),
                                               z[r0:r1], 8)
    for k, v in zip(s, mesh_mod.all_reduce_sum(list(s.values()), mesh.data_group)):
        res[f"f64_{k}"] = v.numpy()
    np.savez(f"{out}.{rank}.npz", **res)
    dist.destroy_process_group()


def oracle_samples(rank, world, store, shape, out, x, n_sweeps, burnin):
    """The z trace of 4 bb chains over x on a `shape` mesh after burnin sweeps:
    this rank's rows of its chains, [T, C_local, n_local]."""
    _join(rank, world, store)
    mesh = mesh_mod.make_mesh(*shape, backend="gloo", device="cpu")
    n, C = len(x), 4
    defn = st.model_definition(n, [models.bb], k_max=16)
    data = ((torch.from_numpy(x), torch.ones(n)),)
    states, local = mesh_mod.shard_state(mesh, chain_states(defn, data, C, 11), data)
    sweep = sharded.make_sharded_sweep(mesh, states, local)
    gens = sharded.chain_generators(mesh, 13, C)
    trace = []
    for t in range(n_sweeps + burnin):
        states = sweep(states, local, gens)
        if t >= burnin:
            trace.append(states.assignments.numpy().copy())
    np.save(f"{out}.{rank}.npy", np.stack(trace))
    dist.destroy_process_group()


def assemble_trace(out, shape):
    """[T * C, n] canonical-order samples from the ranks' traces of `oracle_samples`."""
    chains, data = shape
    rows = []
    for c in range(chains):
        parts = [np.load(f"{out}.{c * data + d}.npy") for d in range(data)]  # [T, C_local, n_local]
        rows.append(np.concatenate(parts, axis=-1))
    z = np.concatenate(rows, axis=1)  # [T, C, n]
    return z.reshape(-1, z.shape[-1])


# ---------------------------------------------------------------------------
# particle-sharded SMC
# ---------------------------------------------------------------------------
def bb_problem(n, seed, k_max):
    """tests/test_smc.py's bb rows: n coin flips from numpy seed `seed`."""
    x = np.random.default_rng(seed).integers(0, 2, size=n)
    return st.model_definition(n, [models.bb], k_max=k_max), ((torch.from_numpy(x), torch.ones(n)),)


def smc_runs(rank, world, store, out, n_particles, seeds):
    """`run_sharded` (tests/test_smc.py:111's problem) and
    `run_blocked_sharded` (its :318 problem) on `world` ranks, one run a
    seed: the logz of each and whether every particle seats every row."""
    _join(rank, world, store)
    mesh = smc.make_particle_mesh("gloo", device="cpu")
    res = {}
    for kind, (n, seed_x, k_max) in (("row", (6, 1, 7)), ("blocked", (6, 1, 16))):
        defn, data = bb_problem(n, seed_x, k_max)
        logz, seated = [], []
        for seed in seeds:
            g = torch.Generator().manual_seed(seed)
            parts = smc.init_particles(defn, data, g, n_particles, cluster_hp={"alpha": 1.0})
            parts, sdata = smc.shard_particles(mesh, parts, data)
            gen = torch.Generator().manual_seed(300 + seed)
            if kind == "row":
                r = smc.run_sharded(mesh, parts, sdata, gen)
            else:
                r = smc.run_blocked_sharded(mesh, parts, sdata, gen, block=2)
            logz.append(float(r.logz))
            seated.append(bool((r.particles.counts.sum(-1) == n).all())
                          and bool((r.particles.assignments >= 0).all()))
        res[f"{kind}_logz"] = np.asarray(logz)
        res[f"{kind}_seated"] = np.asarray(seated)
    np.savez(f"{out}.{rank}.npz", **res)
    dist.destroy_process_group()
