"""Worker processes of the port's multi-process tests (gloo over CPU processes).

`tests/test_torch_parallel.py`, `tests/test_torch_smc_sharded.py`,
`tests/test_torch_hdp_sharded.py` and `tests/test_torch_irm_sharded.py` spawn
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
from common_tpu_torch import relational as irm
from common_tpu_torch import state as st
from common_tpu_torch import topic
from common_tpu_torch.data import sparse_ndarray_dataview, variadic_dataview
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


def noise_checks(rank, world, store, out):
    """On a (1 x 2) mesh, 3 sharded sweeps of one chain over 40 rows, some
    masked, for bb (the plain route) and niw (kernel 1's plain version and
    the fallback): every Gumbel draw, recorded as the stream it came from
    (a rank stream made by `shard_generator`, the chain's generator, or
    another, such as kernel 1's plain version's own), its shape and its
    values; and the chain generator's state after the sweeps."""
    import sys

    rng_mod = sys.modules["common_tpu_torch.rng"]  # the module; the package exports the class `rng`
    _join(rank, world, store)
    mesh = mesh_mod.make_mesh(1, 2, backend="gloo", device="cpu")
    made, chain, draws = [], [], []
    real_gumbel, real_shard = rng_mod.gumbel, mesh_mod.shard_generator

    def shard(generator, index):
        g = real_shard(generator, index)
        made.append(g)
        return g

    def gumbel(shape, generator, dtype=torch.float32):
        g = real_gumbel(shape, generator, dtype)
        kind = ("stream" if any(generator is m for m in made)
                else "chain" if generator is chain[0] else "other")
        draws.append((kind, tuple(shape), g.clone()))
        return g

    rng_mod.gumbel, mesh_mod.shard_generator = gumbel, shard
    res = {}
    n = 40
    mask = torch.from_numpy((np.random.default_rng(2).random(n) > 0.2).astype(np.float32))
    for lik in ("bb", "niw"):
        defn, data = bb_problem(n, 3, 8) if lik == "bb" else niw_problem(n, k_max=8, seed=3)
        data = ((data[0][0], mask),)
        states, local = mesh_mod.shard_state(mesh, chain_states(defn, data, 1, 0), data)
        sweep = sharded.make_sharded_sweep(mesh, states, local)
        gens = sharded.chain_generators(mesh, 7, 1)
        chain[:] = gens
        draws.clear()
        for _ in range(3):
            states = sweep(states, local, gens)
        stream = [(shape, g) for kind, shape, g in draws if kind == "stream"]
        res[f"{lik}_stream_shapes"] = np.asarray([shape for shape, _ in stream])
        res[f"{lik}_chain_draws"] = np.asarray(sum(kind == "chain" for kind, _, _ in draws))
        res[f"{lik}_first_noise"] = stream[0][1].numpy()
        res[f"{lik}_gen_state"] = gens[0].get_state().numpy()
    rng_mod.gumbel, mesh_mod.shard_generator = real_gumbel, real_shard
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


# ---------------------------------------------------------------------------
# the sharded HDP sweeps
# ---------------------------------------------------------------------------
def hdp_corpus(n_docs=40, doc_len=24, v_per_topic=8, kb=3, seed=1):
    """tests/test_hdp.py's `_synthetic_corpus`: (rows, V), topics with
    disjoint vocabularies, 15% noise tokens."""
    r = np.random.default_rng(seed)
    V = v_per_topic * kb
    doc_topic = r.integers(0, kb, n_docs)
    rows = []
    for d in range(n_docs):
        k = doc_topic[d]
        own = r.integers(k * v_per_topic, (k + 1) * v_per_topic, doc_len)
        noise = r.integers(0, V, doc_len)
        rows.append(np.where(r.random(doc_len) < 0.15, noise, own))
    return rows, V


def hdp_layout(layout, world, K=8):
    """(corpus, state) of the layout's whole problem: the flat corpus padded
    to a multiple of 8 tokens ("tokens"), or the dense [D, L] one ("dense")."""
    rows, V = hdp_corpus()
    if layout == "tokens":
        total = sum(len(r) for r in rows)
        view = variadic_dataview(rows, pad_to=-(-total // 8) * 8, device="cpu")
        return topic.token_data(view), topic.initialize(view, K, V, torch.Generator().manual_seed(0), eta=0.1)
    words, mask = topic.densify_corpus(variadic_dataview(rows, device="cpu"))
    data = topic.dense_token_data(words, mask)
    state = topic.initialize(data, K, V, torch.Generator().manual_seed(0), eta=0.1, n_docs=len(rows))
    return (words, mask), state


def _hdp_leaves(s):
    return {"z": s.z, "doc_topic": s.doc_topic, "topic_word": s.topic_word, "topic_total": s.topic_total,
            "beta": s.beta, "alpha": s.hypers["alpha"], "gamma": s.hypers["gamma"]}


def hdp_sharded_checks(rank, world, store, layout, out):
    """30 sharded sweeps of `layout` on a (1 x world) mesh, each followed by
    a beta move (on the dense layout with the mesh, and a concentration
    move with it every fifth sweep); this rank's shard of the corpus and
    every leaf of its final state."""
    _join(rank, world, store)
    mesh = mesh_mod.make_mesh(1, world, backend="gloo", device="cpu")
    corpus, state = hdp_layout(layout, world)
    g = torch.Generator().manual_seed(2)
    res = {}
    if layout == "tokens":
        s, d = topic.shard_corpus(mesh, state, corpus)
        sweep = topic.make_sharded_sweep(mesh, s, d)
        for _ in range(30):
            s = topic.sample_beta(sweep(s, d, g, chunk=100), g, max_count=32)
        res.update(words=d.words, doc_ids=d.doc_ids, mask=d.mask)
    else:
        s, w, m = topic.shard_dense_corpus(mesh, state, *corpus)
        sweep = topic.make_sharded_sweep_dense(mesh, s, w, m)
        for i in range(30):
            s = topic.sample_beta(sweep(s, w, m, g, doc_chunk=7), g, mesh=mesh)
            if i % 5 == 4:
                s = topic.sample_concentrations(s, g, mesh=mesh)
        res.update(words=w, mask=m)
    res.update(_hdp_leaves(s))
    res["gen_state"] = g.get_state()
    np.savez(f"{out}.{rank}.npz", **{k: v.numpy() for k, v in res.items()})
    dist.destroy_process_group()


def hdp_tiny(layout):
    """tests/test_hdp.py's oracle problem: 2 docs x 3 tokens, V = 2, K = 2,
    beta fixed at (0.5, 0.3, 0.2), alpha 0.8, eta 0.5; the flat corpus
    padded to 8 tokens ("tokens") or the dense [2, 3] one ("dense").
    Returns (corpus, flat TokenData, state)."""
    import dataclasses

    if layout == "tokens":
        view = variadic_dataview([np.array([0, 0, 1]), np.array([1, 1, 0])], pad_to=8, device="cpu")
        corpus = data = topic.token_data(view)
        state = topic.initialize(view, 2, 2, torch.Generator().manual_seed(0), alpha=0.8, eta=0.5)
    else:
        corpus = (torch.tensor([[0, 0, 1], [1, 1, 0]]), torch.ones((2, 3)))
        data = topic.dense_token_data(*corpus)
        state = topic.initialize(data, 2, 2, torch.Generator().manual_seed(0), alpha=0.8, eta=0.5, n_docs=2)
    return corpus, data, dataclasses.replace(state, beta=torch.tensor([0.5, 0.3, 0.2]))


def hdp_oracle_samples(rank, world, store, layout, out, z0, n_sweeps, seed):
    """The tiny problem's chain from z0 on `world` ranks: this rank's z after
    each sweep, [n_sweeps, local tokens]."""
    import dataclasses

    from common_tpu_torch.topic import hdp

    _join(rank, world, store)
    mesh = mesh_mod.make_mesh(1, world, backend="gloo", device="cpu")
    corpus, data, state = hdp_tiny(layout)
    z = torch.from_numpy(z0)
    dk, kw, kt = hdp._counts(z, data, state.n_docs, state.n_topics, state.vocab_size)
    state = dataclasses.replace(state, z=z, doc_topic=dk, topic_word=kw, topic_total=kt)
    g = torch.Generator().manual_seed(seed)
    trace = []
    if layout == "tokens":
        s, d = topic.shard_corpus(mesh, state, corpus)
        sweep = topic.make_sharded_sweep(mesh, s, d)
        for _ in range(n_sweeps):
            s = sweep(s, d, g)
            trace.append(s.z.numpy().copy())
    else:
        s, w, m = topic.shard_dense_corpus(mesh, state, *corpus)
        sweep = topic.make_sharded_sweep_dense(mesh, s, w, m)
        for _ in range(n_sweeps):
            s = sweep(s, w, m, g)
            trace.append(s.z.numpy().copy())
    np.save(f"{out}.{rank}.npy", np.stack(trace))
    dist.destroy_process_group()


def hdp_quadrature_state(D=8, K=6, V=5):
    """tests/test_hdp.py's concentration case: every doc-topic count 0 or 1
    (three topics a doc), so the CRT table counts equal doc_topic."""
    dt = np.zeros((D, K), np.float32)
    for d in range(D):
        dt[d, [d % K, (d + 1) % K, (d + 2) % K]] = 1.0
    return topic.HDPState(
        z=torch.zeros(int(dt.sum()), dtype=torch.int32), beta=torch.full((K + 1,), 1.0 / (K + 1)),
        doc_topic=torch.from_numpy(dt), topic_word=torch.zeros((K, V)), topic_total=torch.from_numpy(dt.sum(0)),
        hypers={"alpha": torch.tensor(1.0), "gamma": torch.tensor(1.0), "eta": torch.tensor(0.1)})


def hdp_hyper_moves(rank, world, store, out, n_moves, n_betas, a, b):
    """On a (1 x world) mesh, each rank holding its block of the quadrature
    state's docs: n_moves concentration moves (max_count 1), then n_betas
    beta moves, the first with the default max_count (the ranks' max);
    every alpha, gamma and beta drawn, and the generator's final state."""
    import dataclasses

    from common_tpu_torch.topic import hdp

    _join(rank, world, store)
    mesh = mesh_mod.make_mesh(1, world, backend="gloo", device="cpu")
    state = hdp_quadrature_state()
    r0, r1 = mesh_mod.row_span(mesh, state.n_docs)
    state = dataclasses.replace(state, doc_topic=state.doc_topic[r0:r1])
    g = torch.Generator().manual_seed(1)
    hypers, betas = [], []
    for _ in range(n_moves):
        state = hdp._sample_concentrations(state, g, 1, a, b, a, b, mesh)
        hypers.append(torch.stack([state.hypers["alpha"], state.hypers["gamma"]]))
    for i in range(n_betas):
        betas.append(topic.sample_beta(state, g, max_count=None if i == 0 else 1, mesh=mesh).beta)
    np.savez(f"{out}.{rank}.npz", hypers=torch.stack(hypers).numpy(), betas=torch.stack(betas).numpy(),
             gen_state=g.get_state().numpy())
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the cell-sharded IRM sweep
# ---------------------------------------------------------------------------
def irm_problem(seed=0):
    """Three domains (12, 9, 5 entities) and two relations over them: bb on
    (0, 1) and gp on (2, 1), each with missing cells (dense arrays, masks,
    the definition)."""
    r = np.random.default_rng(seed)
    bb = (r.random((12, 9)) < 0.4).astype(np.float32)
    gp = r.poisson(2.0, (5, 9)).astype(np.float32)
    rels = [(bb, r.random((12, 9)) < 0.2), (gp, r.random((5, 9)) < 0.3)]
    defn = irm.model_definition([12, 9, 5], [((0, 1), models.bb), ((2, 1), models.gp)], k_max=[5, 4, 3])
    return rels, defn


def irm_views(rels):
    return irm.as_views([sparse_ndarray_dataview(dense=v, missing_mask=m, device="cpu") for v, m in rels])


def irm_init(defn, views, seed):
    return irm.initialize(defn, views, torch.Generator().manual_seed(seed),
                          cluster_hps=[{"alpha": 1.0}] * defn.ndomains)


def irm_sharded_checks(rank, world, store, out):
    """4 cell-sharded sweeps of `irm_problem` on a (1 x world) mesh: this
    rank's cells and its final assignments, counts, suffstats and
    generator state."""
    _join(rank, world, store)
    mesh = mesh_mod.make_mesh(1, world, backend="gloo", device="cpu")
    rels, defn = irm_problem()
    views = irm_views(rels)
    s = irm_init(defn, views, 0)
    local = irm.kernels.shard_cells(mesh, views)
    sweep = irm.kernels.make_sharded_sweep(mesh, s, local)
    g = torch.Generator().manual_seed(4)
    for _ in range(4):
        s = sweep(s, local, g)
    res = {"gen_state": g.get_state()}
    for r, v in enumerate(local):
        res.update({f"indices{r}": v.indices, f"values{r}": v.values, f"mask{r}": v.mask})
        res.update({f"stats{r}_{k}": t for k, t in s.suffstats[r].items()})
    for d in range(s.ndomains):
        res.update({f"z{d}": s.assignments[d], f"counts{d}": s.counts[d]})
    np.savez(f"{out}.{rank}.npz", **{k: v.numpy() for k, v in res.items()})
    dist.destroy_process_group()


def irm_oracle_samples(rank, world, store, out, rel, k_max, alpha, n_sweeps, seed):
    """A cell-sharded chain over a bipartite bb relation: both domains'
    assignments after each sweep, [n_sweeps, n_0 + n_1] (rank 0 saves)."""
    _join(rank, world, store)
    mesh = mesh_mod.make_mesh(1, world, backend="gloo", device="cpu")
    defn = irm.model_definition(list(rel.shape), [((0, 1), models.bb)], k_max=k_max)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device="cpu")])
    g = torch.Generator().manual_seed(seed)
    s = irm.initialize(defn, views, g, cluster_hps=[{"alpha": alpha}] * 2)
    local = irm.kernels.shard_cells(mesh, views)
    sweep = irm.kernels.make_sharded_sweep(mesh, s, local)
    trace = []
    for _ in range(n_sweeps):
        s = sweep(s, local, g)
        trace.append(torch.cat(s.assignments).numpy())
    if rank == 0:
        np.save(f"{out}.npy", np.stack(trace))
    dist.destroy_process_group()
