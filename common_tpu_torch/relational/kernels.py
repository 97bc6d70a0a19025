"""IRM inference kernels (port of `common_tpu/relational/kernels.py`).

Reference analog: the `irm` sibling repo reuses the kernels repo's Gibbs
drivers (`kernels:microscopes/kernels/gibbs.pyx`) through the
entity_based_state_object interface, with irm's state supplying
score_value over cluster-block suffstats.

  - `assign(state, views, generator, domain=d)`: exact collapsed Gibbs over
    one domain's entities, a Python loop over entities. The JAX package
    scores each of the K_d candidates by scattering ALL M cells of the
    relation (weight 0 off the entity's cells), O(N_d K_d M) a sweep. Here
    an entity step reads only the observed cells that touch it, through a
    per-entity cell index built once on the host (`entity_cells`), sums
    them by the blocks of the other axes in one order-fixed segment sum
    (`utils.segment`), and places the sums in one [K_d, prod K] table of
    candidate deltas: the
    conditional is sum over blocks of marginal_loglik(stats + delta_g) -
    marginal_loglik(stats), where the blocks the entity does not touch give
    exactly 0. A diagonal cell (e, e) of a self-relation moves to the
    candidate on every axis and is counted once; exactly one auxiliary slot,
    the first empty one, may open. No entity step waits for the device. A
    chain stack (`parallel.stack_states`) moves each entity in all its
    chains at once.
  - `sweep(state, views, generator)`: blocked Gibbs. Draw the cluster-block
    parameters theta and each domain's stick weights, then reassign every
    entity of a domain at once from an [N_d, K_d] table of summed per-cell
    logpdfs (built over chunks of cells, so the peak stays bounded, and
    summed in an order fixed by the view, so a seed replays a chain).
    Domains touched by a self-relation (one domain on two or more axes)
    run a sequential-given-theta loop over their entities instead, which
    stays a valid Gibbs update where the parallel one would not; it too
    reads only each entity's own cells.
  - `domain_alpha_escobar_west`, `domain_alpha_grid`: each domain's CRP
    concentration.
  - `shard_cells(mesh, views)` and `make_sharded_sweep(mesh, state, views)`:
    the blocked sweep with each relation's cells sharded over the data axis
    of a `parallel.mesh.Mesh`. theta, the stick weights and the assignments
    are drawn alike on every rank from the chain's generator; each domain's
    [N_d, K_d] table and, at the end, the suffstats are summed over the
    ranks' cells (one all_reduce each). Relations without a repeated
    domain only, as in the JAX package.

Every sampler takes an explicit `torch.Generator` on the state's device and
consumes it in order (the JAX package folds a key per domain and entity).

Under `utils.profiling.recording()`: `sweep` is the span `irm.sweep`, its
theta draw `irm.theta`, each domain's table `irm.table` (counter
`irm.table_chunks`, its chunks of cells), each domain's stick weights and
Gumbel argmax `irm.assign`, a self-relational domain's loop
`irm.sequential`, the rebuild `irm.restat` (counter `irm.restat_chunks` in
`state.compute_relation_stats`); `assign` is `irm.collapsed`, a domain.
None of them reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from common_tpu_torch.kernels.blocked import stick_break_log_weights
from common_tpu_torch.kernels.gibbs import _aux_slot_mask
from common_tpu_torch.parallel import mesh as mesh_mod
from common_tpu_torch.parallel.chains import map_tensors
from common_tpu_torch.relational import state as irm_state
from common_tpu_torch.relational.state import IRMState, _k_maxes
from common_tpu_torch.rng import beta, gumbel, gumbel_argmax, standard_gamma, uniform_open
from common_tpu_torch.state import _assignment_counts
from common_tpu_torch.utils import profiling, segment

NOISE_ENTITIES = 4096     # entities whose Gumbel noise is drawn in one call
TABLE_ELEMS = 1 << 25     # [cells, K] elements of one chunk of the blocked table


def _strides(rel_domains, k_maxes) -> List[int]:
    """Row-major stride of each axis of a relation's flat K-grid."""
    out, s = [], 1
    for dom in reversed(rel_domains):
        out.append(s)
        s *= k_maxes[dom]
    return out[::-1]


def entity_cells(view, rel_domains, domain: int, n_d: int):
    """The observed cells of one relation that touch each entity of
    `domain`, as a CSR over entities: (ptr, cells, occ, kept).

    ptr is a host list [n_d + 1], so a step slices without a device read;
    cells [nnz] int64 and occ [nnz, arity] bool (the axes that hold the
    row's entity) are device tensors; kept lists (axis, always) for each
    axis that does not hold the entity in some row, `always` if in none.
    A cell lists under each distinct entity of `domain` it holds: a
    diagonal cell (e, e) of a self-relation once, under e. Masked and
    padding cells are left out. Built on the host from one read of the
    indices and mask, and kept in `view.entity_cells`.
    """
    key = (tuple(rel_domains), int(domain), int(n_d))
    hit = view.entity_cells.get(key)
    if hit is not None:
        return hit
    idx = view.indices.cpu().numpy()
    observed = view.mask.cpu().numpy() > 0
    axes = [a for a, dom in enumerate(rel_domains) if dom == domain]
    ents, cells = [], []
    for j, a in enumerate(axes):
        keep = observed.copy()
        for b in axes[:j]:
            keep &= idx[:, a] != idx[:, b]  # listed under the earlier axis already
        c = np.nonzero(keep)[0]
        ents.append(idx[c, a].astype(np.int64))
        cells.append(c)
    ents, cells = np.concatenate(ents), np.concatenate(cells)
    order = np.argsort(ents, kind="stable")
    ents, cells = ents[order], cells[order]
    ptr = np.zeros(n_d + 1, np.int64)
    np.cumsum(np.bincount(ents, minlength=n_d), out=ptr[1:])
    occ = np.array([dom == domain for dom in rel_domains])[None, :] & (idx[cells] == ents[:, None])
    kept = tuple((a, not occ[:, a].any()) for a in range(len(rel_domains)) if not occ[:, a].all())
    dev = view.indices.device
    hit = (ptr.tolist(), torch.from_numpy(cells).to(dev), torch.from_numpy(occ).to(dev), kept)
    view.entity_cells[key] = hit
    return hit


@dataclasses.dataclass
class _EntityCells:
    """One relation's cells grouped by entity of one domain, with what an
    entity step needs of them. With the entity in cluster g, its cells lie
    in the flat blocks base + coef * g, where base sums the other axes'
    clusters times their strides (`terms`: axis, domain, and the stride, or
    a per-cell stride that is 0 on rows where the axis holds the entity).

    A cell's class is the set of axes that hold the entity (one class in a
    relation where the domain is on one axis; a self-relation's diagonal
    cells form their own). With the entity in cluster g, block b' takes
    class c's cells summed at base place[c, b'] - c * total where sel[c, g,
    b'] holds: b' is that base with cluster g on every axis of the class."""

    rid: int
    ptr: list
    ind: torch.Tensor        # [nnz, arity] int64
    coef: torch.Tensor       # [nnz] int64
    terms: list
    total: int               # blocks of the relation's K-grid
    payload: dict            # per cell leaves [nnz, ...]
    cls: torch.Tensor        # [nnz] int64 class of each cell
    place: torch.Tensor      # [C, total] int64: class c, the block with its axes at cluster 0
    sel: torch.Tensor        # [C, K_d, total] bool: the block's class axes all at cluster g

    def bins(self, assignments, e: int):
        """(lo, hi, base [..., n_c], coef [n_c]) of entity e; base has the
        assignments' leading (chain) axes."""
        lo, hi = self.ptr[e], self.ptr[e + 1]
        base = 0
        for a, dom, w in self.terms:
            w = w if isinstance(w, int) else w[lo:hi]
            base = base + assignments[dom][..., self.ind[lo:hi, a]].long() * w
        if isinstance(base, int):
            lead = assignments[0].shape[:-1]
            base = torch.zeros((*lead, hi - lo), dtype=torch.int64, device=self.coef.device)
        return lo, hi, base, self.coef[lo:hi]


def _prepare(state: IRMState, views, domain: int, payload_fn) -> List[_EntityCells]:
    """The `_EntityCells` of every relation that ranges over `domain`."""
    k_maxes = _k_maxes(state)
    n_d = state.assignments[domain].shape[-1]
    out = []
    for r, view in enumerate(views):
        doms = state.rel_domains[r]
        if domain not in doms:
            continue
        ptr, cells, occ, kept = entity_cells(view, doms, domain, n_d)
        strides = _strides(doms, k_maxes)
        coef = sum(occ[:, a].long() * stride for a, stride in enumerate(strides))  # no host copy
        terms = [(a, doms[a], strides[a] if always else (~occ[:, a]).long() * strides[a])
                 for a, always in kept]
        axes = [a for a, dom in enumerate(doms) if dom == domain]
        total = int(np.prod([k_maxes[d] for d in doms]))
        blocks = torch.arange(total, device=occ.device)
        g = torch.arange(k_maxes[domain], device=occ.device)
        place, sel = [], []
        for c in range(2 ** len(axes) - 1):  # each non-empty set of the domain's axes
            on = [a for j, a in enumerate(axes) if (c + 1) >> j & 1]
            coords = torch.stack([blocks // strides[a] % k_maxes[domain] for a in on])  # [|on|, total]
            place.append(c * total + blocks - sum(coords[j] * strides[a] for j, a in enumerate(on)))
            sel.append((coords[None] == g[:, None, None]).all(1))
        out.append(_EntityCells(rid=r, ptr=ptr, ind=view.indices[cells], coef=coef, terms=terms, total=total,
                                payload=payload_fn(r, view, cells),
                                cls=sum(occ[:, a].long() << j for j, a in enumerate(axes)) - 1,
                                place=torch.stack(place), sel=torch.stack(sel)))
    return out


def _working_copy(state: IRMState) -> IRMState:
    """Fresh assignments, counts and suffstats, updated in place by a sweep."""
    return dataclasses.replace(
        state,
        assignments=tuple(a.clone() for a in state.assignments),
        counts=tuple(c.clone() for c in state.counts),
        suffstats=tuple({k: v.clone() for k, v in s.items()} for s in state.suffstats),
    )


def _flat(stats, n_axes: int):
    """A relation's stats leaves as views [prod K, *event]."""
    return {k: v.view(-1, *v.shape[n_axes:]) for k, v in stats.items()}


# ---------------------------------------------------------------------------
# exact collapsed Gibbs over one domain
# ---------------------------------------------------------------------------
def _remove_and_score(st: IRMState, preps, domain: int, e: int):
    """Remove entity e of `domain` from the working copy `st` (in place) in
    each of its P chains (every tensor with a leading chain axis) and return
    the log conditional [P, K_d] of its candidate clusters (CRP weights plus
    the change of the summed block marginals), and each relation's
    contributions of the entity in each candidate cluster, {leaf: [P, K_d,
    prod K, ...]}, for the add that follows.

    Per relation, the entity's cells are summed by (chain, class, base) in
    one order-fixed segment sum (`utils.segment`), then placed in each
    candidate's blocks (`_EntityCells`: distinct blocks within a class, the
    classes added in order). One [P, K_d + 1, prod K] table holds the stats
    without the entity (row 0) and with it in each candidate cluster (rows
    1..K_d), so one marginal_loglik call scores all of them; blocks the
    entity does not touch are equal in every row and difference to exactly 0.
    """
    n_p, K = st.counts[domain].shape
    liks = st.likelihoods()
    chain = torch.arange(n_p, device=st.device)
    old = st.assignments[domain][:, e].long()
    delta, moves = 0.0, []
    for p in preps:
        lo, hi, base, _ = p.bins(st.assignments, e)
        n_axes = len(st.rel_domains[p.rid])
        n_cls = p.place.shape[0]
        ids = base + p.cls[lo:hi] * p.total + (chain * (n_cls * p.total))[:, None]
        by_base = segment.segments(ids.reshape(-1), n_p * n_cls * p.total)
        placed, cand = {}, {}
        for k, v in st.suffstats[p.rid].items():
            event = v.shape[1 + n_axes:]
            s = v.view(n_p, p.total, *event)
            t = p.payload[k][lo:hi]
            sums = by_base.sum(t.expand(n_p, *t.shape).reshape(-1, *event)).view(n_p, n_cls * p.total, *event)
            at = sums[:, p.place.view(-1)].view(n_p, n_cls, 1, p.total, *event)
            d = torch.where(p.sel.view(1, n_cls, K, p.total, *(1,) * len(event)), at, 0).sum(1)  # classes in order
            placed[k] = d
            s -= d[chain, old]
            cand[k] = torch.cat([s[:, None], s[:, None] + d], 1)
        hyper = {k: v.reshape(n_p, 1, 1, *v.shape[1:]) for k, v in st.hypers[p.rid].items()}
        ml = liks[p.rid].marginal_loglik(hyper, cand)
        delta = delta + (ml[:, 1:] - ml[:, :1]).sum(-1)
        moves.append(placed)
    counts = st.counts[domain]
    counts.view(-1).index_add_(0, chain * K + old, torch.full((n_p,), -1, dtype=counts.dtype, device=counts.device))
    alpha = st.cluster_hps[domain]["alpha"][:, None]
    crp = torch.where(_aux_slot_mask(counts, 1), torch.log(alpha), torch.log(counts.to(alpha.dtype)))
    return crp + delta, moves


def _add(st: IRMState, preps, domain: int, e: int, gid, moves) -> None:
    """Seat entity e of `domain` at cluster gid [P] (device) in every chain."""
    n_p, K = st.counts[domain].shape
    chain = torch.arange(n_p, device=st.device)
    for p, placed in zip(preps, moves):
        n_axes = len(st.rel_domains[p.rid])
        for k, v in st.suffstats[p.rid].items():
            v.view(n_p, p.total, *v.shape[1 + n_axes:]).add_(placed[k][chain, gid])
    counts = st.counts[domain]
    counts.view(-1).index_add_(0, chain * K + gid, torch.ones(n_p, dtype=counts.dtype, device=counts.device))
    st.assignments[domain][:, e] = gid


def _tx_payload(work: IRMState):
    """Each cell's suffstat contribution, for `_prepare` on a chain stack."""
    liks = work.likelihoods()

    def payload(r, view, cells):
        hyper = {k: v[0] for k, v in work.hypers[r].items()}  # tx reads their dtype only
        txs = liks[r].tx(hyper, view.values, view.mask)
        return {k: t[cells] for k, t in txs.items()}

    return payload


def assign(state: IRMState, views, generator: torch.Generator, domain: int = 0) -> IRMState:
    """One exact collapsed-Gibbs sweep over `domain`'s entities, in order.
    The caller's state is unchanged.

    A chain-stacked state (`parallel.stack_states`) moves entity e in every
    chain at once, each chain with its own noise; one state is a stack of
    one, viewed as such.
    """
    views = irm_state.as_views(views)
    with profiling.span("irm.collapsed"):
        st = _working_copy(state)
        stacked = st.counts[domain].dim() == 2
        work = st if stacked else map_tensors(lambda t: t.unsqueeze(0), st)
        preps = _prepare(work, views, domain, _tx_payload(work))
        n_p, K = work.counts[domain].shape
        n = work.assignments[domain].shape[-1]
        dt = work.cluster_hps[domain]["alpha"].dtype
        for start in range(0, n, NOISE_ENTITIES):
            noise = gumbel((min(NOISE_ENTITIES, n - start), n_p, K), generator, dt)
            for i in range(noise.shape[0]):
                e = start + i
                logp, moves = _remove_and_score(work, preps, domain, e)
                _add(work, preps, domain, e, torch.argmax(logp + noise[i], -1), moves)
    return st


def assign_all(state: IRMState, views, generator: torch.Generator) -> IRMState:
    """Collapsed sweep over every domain in turn."""
    for d in range(state.ndomains):
        state = assign(state, views, generator, domain=d)
    return state


# ---------------------------------------------------------------------------
# blocked (uncollapsed) sweep
# ---------------------------------------------------------------------------
def _sample_block_params(state: IRMState, generator: torch.Generator):
    """theta for every cluster block of every relation (posterior draws;
    empty blocks draw from the prior)."""
    with profiling.span("irm.theta"):
        return tuple(
            lik.sample_params(generator, hyper, stats)
            for lik, hyper, stats in zip(state.likelihoods(), state.hypers, state.suffstats)
        )


def _theta_at_cells(theta, rel_domains, assignments, indices, free_axis):
    """Gather theta leaves to [M, K_free, *event]: every block axis fixed at
    its cells' current cluster, except `free_axis`, which stays free."""
    n_block = len(rel_domains)
    fixed_axes = [a for a in range(n_block) if a != free_axis]

    def gather(leaf):
        moved = torch.movedim(leaf, free_axis, n_block - 1)  # free axis last
        flat_fixed = torch.zeros(indices.shape[0], dtype=torch.int64, device=indices.device)
        for a in fixed_axes:
            flat_fixed = flat_fixed * leaf.shape[a] + assignments[rel_domains[a]][indices[:, a]]
        total_fixed = int(np.prod([leaf.shape[a] for a in fixed_axes])) if fixed_axes else 1
        return moved.reshape(total_fixed, *moved.shape[n_block - 1:])[flat_fixed]

    return {k: gather(v) for k, v in theta.items()}


def _table_layout(view, rel_domains, axis: int, n_d: int, chunk: int):
    """The blocked table's cell order for one axis of one relation: (order,
    [(lo, hi, Segments)]). order [M] int32 lists the cells by the entity on
    `axis` (row order within an entity, masked and padding cells last); each
    chunk of at most `chunk` cells of that order carries its
    `utils.segment.Segments` over the n_d entities. Built on the device with
    no host read at first use and kept in `view.cell_orders`, as the
    entities of a view's cells never change."""
    key = (tuple(rel_domains), int(axis), int(n_d), int(chunk))
    hit = view.cell_orders.get(key)
    if hit is not None:
        return hit
    ent = torch.where(view.mask > 0, view.indices[:, axis], n_d).to(torch.int32)
    ent, order = torch.sort(ent, stable=True)
    m = ent.shape[0]
    hit = (order.to(torch.int32), [(lo, min(m, lo + chunk), segment.sorted_segments(ent[lo:lo + chunk], n_d))
                                   for lo in range(0, m, chunk)])
    view.cell_orders[key] = hit
    return hit


def _domain_loglik_table(state: IRMState, views, thetas, domain: int):
    """[N_d, K_d] sum over relations and axes of per-cell logpdf contributions,
    built over chunks of at most TABLE_ELEMS / K_d cells taken in entity
    order (`_table_layout`), each chunk's rows summed by
    `utils.segment.Segments` and added to the table in chunk order: every
    entry sums in an order fixed by the view, with no atomics."""
    n_d = state.assignments[domain].shape[-1]
    K = state.counts[domain].shape[-1]
    liks = state.likelihoods()
    dt = next(iter(thetas[0].values())).dtype
    chunk = max(1, TABLE_ELEMS // K)
    with profiling.span("irm.table"):
        table = torch.zeros((n_d, K), dtype=dt, device=state.device)
        for r, view in enumerate(views):
            doms = state.rel_domains[r]
            for axis, dom in enumerate(doms):
                if dom != domain:
                    continue
                order, chunks = _table_layout(view, doms, axis, n_d, chunk)
                profiling.count("irm.table_chunks", len(chunks))
                for lo, hi, seg in chunks:
                    cells = order[lo:hi]
                    # a column at a time: index_select of the rows of a row-major [M, arity]
                    # tensor (as `shard_cells` makes) is many times slower on the card
                    ind = view.indices.t().index_select(1, cells).t()
                    th = _theta_at_cells(thetas[r], doms, state.assignments, ind, axis)
                    lp = liks[r].logpdf(th, view.values.index_select(0, cells)[:, None])
                    table += seg.sum(lp * view.mask.index_select(0, cells)[:, None].to(lp.dtype))
    return table


def _self_relational(state: IRMState, domain: int) -> bool:
    return any(sum(1 for d in doms if d == domain) >= 2 for doms in state.rel_domains)


def _sequential_given_theta(state: IRMState, views, thetas, domain: int, logw, generator):
    """Valid Gibbs over a self-relational domain: entities in order, each
    scored against theta with the current (in-loop) assignments of its
    peers, from its own cells only. Each cell counts once, with the
    candidate cluster on every axis the entity holds, so a diagonal cell
    (e, e) scores against theta[k, k]."""
    n_d = state.assignments[domain].shape[-1]
    K = state.counts[domain].shape[-1]
    liks = state.likelihoods()
    z_d = state.assignments[domain].clone()
    assignments = list(state.assignments)
    assignments[domain] = z_d
    with profiling.span("irm.sequential"):
        preps = _prepare(state, views, domain, lambda r, view, cells: {"x": view.values[cells]})
        flat_theta = [_flat(thetas[p.rid], len(state.rel_domains[p.rid])) for p in preps]
        ar = torch.arange(K, device=state.device)
        for start in range(0, n_d, NOISE_ENTITIES):
            noise = gumbel((min(NOISE_ENTITIES, n_d - start), K), generator, logw.dtype)
            for i in range(noise.shape[0]):
                e = start + i
                logp = logw
                for p, th_flat in zip(preps, flat_theta):
                    lo, hi, base, coef = p.bins(assignments, e)
                    bins_k = base[:, None] + coef[:, None] * ar[None, :]  # [n_c, K]
                    th = {k: v[bins_k] for k, v in th_flat.items()}
                    logp = logp + liks[p.rid].logpdf(th, p.payload["x"][lo:hi, None]).sum(0)
                z_d[e] = torch.argmax(logp + noise[i])
    return z_d


def restat(state: IRMState, views) -> IRMState:
    """Counts and suffstats rebuilt from the assignments."""
    k_maxes = _k_maxes(state)
    with profiling.span("irm.restat"):
        counts = tuple(_assignment_counts(a, k) for a, k in zip(state.assignments, k_maxes))
        stats = tuple(
            irm_state.compute_relation_stats(lik, state.hypers[r], state.rel_domains[r],
                                             state.assignments, views[r], k_maxes)
            for r, lik in enumerate(state.likelihoods())
        )
    return dataclasses.replace(state, counts=counts, suffstats=stats)


def _sweep_domain(state: IRMState, views, thetas, domain: int, generator: torch.Generator,
                  group=None):
    """z_d | theta, z_-d: the new [N_d] assignment of one domain. With a
    process group, views are the rank's cells and the table is summed over
    the group's ranks. The table draws no noise, so the stick weights, drawn
    after it, take the generator where a draw before it would."""
    alpha = state.cluster_hps[domain]["alpha"]
    if _self_relational(state, domain):
        logw = stick_break_log_weights(generator, state.counts[domain], alpha)
        return _sequential_given_theta(state, views, thetas, domain, logw, generator)
    table = _domain_loglik_table(state, views, thetas, domain)
    if group is not None:
        (table,) = mesh_mod.all_reduce_sum([table], group)
    with profiling.span("irm.assign"):
        logw = stick_break_log_weights(generator, state.counts[domain], alpha)
        return gumbel_argmax(logw.to(table.dtype)[None, :] + table, generator).to(torch.int32)


def _sweep_domains(state: IRMState, views, generator: torch.Generator, group=None) -> IRMState:
    """theta | z, then z_d | theta, z_-d and its counts for each domain in turn."""
    thetas = _sample_block_params(state, generator)
    for d in range(state.ndomains):
        z_new = _sweep_domain(state, views, thetas, d, generator, group)
        assignments = list(state.assignments)
        assignments[d] = z_new
        counts = list(state.counts)
        counts[d] = _assignment_counts(assignments[d], state.k_max(d))
        state = dataclasses.replace(state, assignments=tuple(assignments), counts=tuple(counts))
    return state


def sweep(state: IRMState, views, generator: torch.Generator) -> IRMState:
    """One blocked sweep: theta | z, then z_d | theta, z_-d for each domain in
    turn, then the suffstats rebuilt from the new assignments."""
    views = irm_state.as_views(views)
    with profiling.span("irm.sweep"):
        return restat(_sweep_domains(state, views, generator), views)


# ---------------------------------------------------------------------------
# multi-device: cell-sharded blocked sweep
# ---------------------------------------------------------------------------
def shard_cells(mesh, views):
    """This rank's cells of each relation, on the mesh's device: the cell
    axis padded to a multiple of the data ranks, then the rank's contiguous
    slice of it. Padding cells carry mask 0 and index 0, so no table or
    suffstat counts them."""
    out = []
    for v in irm_state.as_views(views, device=mesh.device):
        m = v.indices.shape[0]
        pad = (-m) % mesh.data
        a, b = mesh_mod._span(m + pad, mesh.data, mesh.data_index, "cells")

        def padded(t):
            return torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])[a:b].to(mesh.device).contiguous()

        out.append(irm_state.RelView(padded(v.indices), padded(v.values), padded(v.mask)))
    return tuple(out)


def make_sharded_sweep(mesh, state: IRMState, views):
    """The cell-sharded blocked sweep: (state, views_blk, generator) -> state,
    on this rank (`shard_cells`'s layout; the state whole on every rank).

    theta, every domain's stick weights and its Gumbel argmax over the
    [N_d, K_d] table are drawn from `generator`, seeded alike on every data
    rank, in `sweep`'s order; the table of the rank's cells is summed over
    the data ranks (one all_reduce a domain) and so is every relation's
    suffstat block at the end (one all_reduce). The assignments are the
    same on every rank, and at one data rank the sweep is `sweep` bit for
    bit (the table and the suffstats are order-fixed segment sums, and the
    padding cells of `shard_cells` are dropped from them). A domain on two
    axes of one relation (a self-relation) needs `sweep`'s sequential loop
    over all its cells: refused (ValueError).
    """
    if any(_self_relational(state, d) for d in range(state.ndomains)):
        raise ValueError(
            "the cell-sharded sweep supports only relations without repeated domains "
            "(a self-relation needs the sequential-given-theta loop over all its cells); "
            "use kernels.sweep on one device for those")
    del views

    def sweep(state: IRMState, views_blk, generator: torch.Generator) -> IRMState:
        views_blk = irm_state.as_views(views_blk)
        state = _sweep_domains(state, views_blk, generator, mesh.data_group)
        k_maxes = _k_maxes(state)
        local = [irm_state.compute_relation_stats(lik, state.hypers[r], state.rel_domains[r],
                                                  state.assignments, views_blk[r], k_maxes)
                 for r, lik in enumerate(state.likelihoods())]
        reduced = iter(mesh_mod.all_reduce_sum([t for s in local for t in s.values()], mesh.data_group))
        return dataclasses.replace(state, suffstats=tuple({k: next(reduced) for k in s} for s in local))

    return sweep


# ---------------------------------------------------------------------------
# domain concentration (alpha) hyper kernels
# ---------------------------------------------------------------------------
def _escobar_west_draw(generator, alpha, n, kplus, a: float, b: float):
    """One exact Gibbs draw of a CRP concentration (Escobar & West 1995, section 6)
    given n customers at kplus tables under alpha ~ Gamma(a, b)."""
    n1 = n.clamp(min=1.0)
    eta = beta(alpha + 1.0, n1, generator)
    log_eta = torch.log(torch.clamp(eta, min=1e-30))
    odds = (a + kplus - 1.0) / (n1 * (b - log_eta))
    pick_high = uniform_open((), generator, alpha.dtype) < odds / (1.0 + odds)
    shape = torch.where(pick_high, a + kplus, a + kplus - 1.0)
    return standard_gamma(shape, generator) / (b - log_eta)


def domain_alpha_escobar_west(state: IRMState, generator: torch.Generator,
                              a: float = 1.0, b: float = 1.0) -> IRMState:
    """Resample every domain's CRP concentration alpha | partition: one
    independent Escobar-West draw a domain, domains in order."""
    new_chps = []
    for d in range(state.ndomains):
        alpha = state.cluster_hps[d]["alpha"]
        n = state.counts[d].sum().to(alpha.dtype)
        kplus = (state.counts[d] > 0).sum().to(alpha.dtype)
        new_alpha = _escobar_west_draw(generator, alpha, n, kplus, float(a), float(b))
        new_chps.append({**state.cluster_hps[d], "alpha": new_alpha.to(alpha.dtype)})
    return dataclasses.replace(state, cluster_hps=tuple(new_chps))


def domain_alpha_grid(state: IRMState, prior_fn: Callable, grid, generator: torch.Generator) -> IRMState:
    """Grid Gibbs over each domain's alpha: prior(alpha) + that domain's EPPF.

    grid: [G] alpha values shared by all domains; each domain draws from its
    own grid posterior, domains in order.
    """
    new_chps = []
    for d in range(state.ndomains):
        alpha = state.cluster_hps[d]["alpha"]
        g = torch.as_tensor(np.asarray(grid), device=state.device).to(alpha.dtype)
        logps = prior_fn(g).to(alpha.dtype) + irm_state._crp_eppf(state.counts[d], g)
        pick = gumbel_argmax(logps, generator).reshape(1)
        new_chps.append({**state.cluster_hps[d], "alpha": g.index_select(0, pick)[0]})
    return dataclasses.replace(state, cluster_hps=tuple(new_chps))

