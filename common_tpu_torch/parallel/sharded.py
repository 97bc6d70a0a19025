"""The data- and chain-sharded blocked-Gibbs sweep over a (chains x data)
mesh (port of `common_tpu/parallel/sharded.py`).

Rows are split over the `data` axis and chains over the `chains` axis. A
sweep's only exchange is one all_reduce of the per-cluster counts and
suffstats over the chain's `data` ranks; everything else is local. Each
chain's generator is seeded identically on every data rank of its chain
row and consumed in the same order there, so the theta draws and the stick
weights, computed from the same all-reduced stats, agree bit for bit
without a broadcast (the JAX design, `common_tpu/parallel/sharded.py:1-13`).

Per chain, on each data rank:

1. theta and the stick weights from the global stats (the chain's generator);
2. assign the rank's rows:
   - a single niw feature: kernel 1 (`ops/gaussian_assign.py`) with
     `row_offset` = the shard's first global row, so the shard draws the
     noise a whole-data launch draws for its rows; rows with a zero mask
     are assigned from the weights alone;
   - any other likelihood set: the plain route of `blocked.sweep`;
3. the local counts and stats (niw: sum_xxT by kernel 2,
   `ops/suffstat.py`), all-reduced over the chain's data ranks; latent
   leaves are kept from theta.

The Gumbel noise of step 2's plain route and of the niw fallback is
[N_local, K], drawn from the rank's own stream (`mesh.data_generator`:
derived on the host from the chain's generator and the rank's data index,
as the JAX package folds the data index into the chain's key), so the
noise a rank draws shrinks with the data ranks, no two ranks share it, and
the chain's generator advances alike on every rank. At one data rank that
stream is the chain's generator itself: with the all-reduce the identity,
at world size 1 `make_sharded_sweep`'s sweep returns `blocked.sweep_fused`'s
state (niw) or `blocked.sweep`'s (any other set) bit for bit, given the
same state and generator. Per-sweep exchange per chain: O(K x suffstat),
e.g. K = 64, niw at D = 256: 64 (1 + 256 + 256^2) x 4 B = 17 MB,
independent of N.

    mesh = make_mesh(chains=2, data=2, backend="gloo", device="cpu")
    states = initialize_chains(defn, data, init_gens)  # all 4 chains, alike on every rank
    states, local = shard_state(mesh, states, data)    # this rank's chains and rows
    sweep = make_sharded_sweep(mesh, states, local)
    gens = chain_generators(mesh, seed, n_chains=4)    # this rank's chains' generators
    states = sweep(states, local, gens)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from common_tpu_torch import state as state_mod
from common_tpu_torch.kernels import blocked
from common_tpu_torch.ops.gaussian_assign import fused_gaussian_assign
from common_tpu_torch.parallel import mesh as mesh_mod
from common_tpu_torch.parallel.chains import stack_states, unstack_state
from common_tpu_torch.rng import device_seed, gumbel_argmax
from common_tpu_torch.state import MixtureState


def _local_sweep(state_c: MixtureState, data_blk, generator, mesh, row0: int) -> MixtureState:
    """One chain's sweep on this rank's rows; returns the state with the
    rank's assignments and the all-reduced counts and stats."""
    K = state_c.k_max
    thetas = None
    if state_c.lik_names == ("niw",):
        x, mask = data_blk[0]
        mu, binv, base, logw = blocked.fused_assign_inputs(state_c, data_blk, generator)
        z = fused_gaussian_assign(x, mu, binv, base, device_seed(generator, x.device),
                                  row_offset=row0)
        m = mask.to(x.dtype)
        z = blocked._prior_fallback(z, logw, m, mesh_mod.data_generator(mesh, generator))
        local = [blocked._fused_niw_stats(x, m, z, K)]
    else:
        thetas, logw, loglik_table = blocked.sweep_parts(state_c, data_blk, generator)
        logp = logw[None, :] + loglik_table(data_blk)  # [n, K]; masked rows score 0
        z = gumbel_argmax(logp, mesh_mod.data_generator(mesh, generator)).to(torch.int32)
        local = [lik.stats_from_assignments(hyper, x, mask, z, K)
                 for (x, mask), lik, hyper in zip(data_blk, state_c.likelihoods(), state_c.hypers)]

    leaves = [state_mod._assignment_counts(z, K)] + [s[k] for s in local for k in s]
    reduced = iter(mesh_mod.all_reduce_sum(leaves, mesh.data_group))
    counts = next(reduced)
    new_stats = []
    for f, (s, lik) in enumerate(zip(local, state_c.likelihoods())):
        s = {k: next(reduced) for k in s}
        if thetas is not None and lik.latent_leaves:
            s = {k: (thetas[f][k] if k in lik.latent_leaves else s[k]) for k in s}
        new_stats.append(s)
    return dataclasses.replace(state_c, assignments=z, counts=counts, stats=tuple(new_stats))


def make_sharded_sweep(mesh, states: MixtureState, data):
    """The sharded sweep: (states, data, generators) -> states, on this rank.

    states: this rank's chain-stacked shard (`shard_state`): leading axis
    C_local on every leaf, assignments [C_local, N_local]. data: this
    rank's rows of the columns. generators: one per local chain, each
    seeded identically on every data rank of the mesh's chain row
    (`chain_generators`); local chains are swept in turn, each consuming
    its own. Every data rank must hold the same number of rows: checked
    here with one all_gather.
    """
    n_local = data[0][0].shape[0]
    if states.assignments.shape[-1] != n_local:
        raise ValueError(f"assignments hold {states.assignments.shape[-1]} rows, the data {n_local}")
    mesh_mod.require_equal_shards(mesh, n_local, "row")
    row0 = mesh.data_index * n_local
    n_chains = states.counts.shape[0]

    def sweep(states_blk: MixtureState, data_blk, generators) -> MixtureState:
        blocked._require_fp32()
        if len(generators) != n_chains:
            raise ValueError(f"{n_chains} local chains need {n_chains} generators, got {len(generators)}")
        return stack_states([
            _local_sweep(unstack_state(states_blk, c), data_blk, generators[c], mesh, row0)
            for c in range(n_chains)
        ])

    return sweep


def chain_seed(seed: int, chain: int) -> int:
    """The seed of global chain `chain`'s generator (SeedSequence of (seed, chain))."""
    return int(np.random.SeedSequence([seed, chain]).generate_state(1, np.uint64)[0] >> 1)


def chain_generators(mesh, seed: int, n_chains: int):
    """Generators of this rank's chains of n_chains, on the mesh's device:
    the same on every data rank of its chain row."""
    c0, c1 = mesh_mod.chain_span(mesh, n_chains)
    return [torch.Generator(device=mesh.device).manual_seed(chain_seed(seed, c)) for c in range(c0, c1)]


def initialize_chains(defn, data, generators, **kwargs) -> MixtureState:
    """C independent chain states stacked on a leading axis, one a generator."""
    return stack_states([state_mod.initialize(defn, data, g, **kwargs) for g in generators])


def gather_chain(mesh, states: MixtureState, i: int) -> MixtureState:
    """Local chain i as an unstacked state with all N assignments,
    all-gathered over the chain's data ranks (every one of them calls it)."""
    s = unstack_state(states, i)
    return dataclasses.replace(s, assignments=mesh_mod.all_gather_cat(s.assignments, mesh.data_group))
