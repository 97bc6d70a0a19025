"""Infinite Relational Model state (port of `common_tpu/relational/state.py`).

Reference analog: the `irm` sibling repo (`irm:microscopes/irm/model.pyx`,
`irm:src/irm/state.cpp`): one CRP `group_manager` a domain and one suffstat
table a relation, indexed by cluster tuples, driven through the
`entity_based_state_object` kernel interface, over `common`'s
sparse_ndarray dataview.

As in the JAX package, every domain gets the padded-K treatment of the
mixture state (assignments [N_d] int32, counts [K_d] int32, a 0-d alpha),
and every relation keeps its suffstats as dense cluster-block tensors of
shape [K_a, K_b, ...] (one slot a cluster tuple; empty blocks hold zero
stats, which score 0 under every conjugate marginal, so nothing needs a
mask). A suffstat rebuild is one order-fixed segment sum (`utils.segment`)
a leaf over the observed COO cells into the flat K-grid. The state's
tensors live on the device of the relation views; its floats follow the
first view's values where those are floating, else float32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from common_tpu_torch import state as mix_state
from common_tpu_torch import validator
from common_tpu_torch.likelihoods import base as lik_base
from common_tpu_torch.models import model_descriptor
from common_tpu_torch.utils import profiling, segment


STATS_CELLS = 1 << 22  # cells of one chunk of a suffstat rebuild


# ---------------------------------------------------------------------------
# definition
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RelationDefinition:
    """One relation: which domain each axis ranges over, and its likelihood."""

    domains: Tuple[int, ...]
    model: model_descriptor

    def __post_init__(self):
        validator.validate_nonempty(self.domains, "relation domains")
        object.__setattr__(self, "domains", tuple(int(d) for d in self.domains))


@dataclass(frozen=True)
class IRMDefinition:
    """Domains (entity counts) + typed relations over them.

    Mirrors irm's ``model_definition([n1, n2], [((0, 1), bb), ...])``.
    """

    domain_sizes: Tuple[int, ...]
    relations: Tuple[RelationDefinition, ...]
    k_maxes: Tuple[int, ...]

    def __post_init__(self):
        for n in self.domain_sizes:
            validator.validate_positive(n, "domain size")
        for k in self.k_maxes:
            validator.validate_positive(k, "k_max")
        validator.validate_nonempty(self.relations, "relations")
        for r in self.relations:
            for d in r.domains:
                if not 0 <= d < len(self.domain_sizes):
                    raise ValueError(f"relation references unknown domain {d}")

    @property
    def ndomains(self) -> int:
        return len(self.domain_sizes)


def model_definition(
    domain_sizes: Sequence[int],
    relations: Sequence,
    k_max: int | Sequence[int] = 8,
) -> IRMDefinition:
    """relations: [(domain-tuple, model_descriptor), ...] (irm's format)."""
    rels = tuple(
        r if isinstance(r, RelationDefinition) else RelationDefinition(*r)
        for r in relations
    )
    if isinstance(k_max, int):
        k_maxes = tuple(k_max for _ in domain_sizes)
    else:
        k_maxes = tuple(int(k) for k in k_max)
        validator.validate_len(k_maxes, len(domain_sizes), "k_max list")
    return IRMDefinition(tuple(int(n) for n in domain_sizes), rels, k_maxes)


@dataclass(frozen=True, eq=False)
class RelView:
    """COO view of one relation: indices [M, arity] int64 (torch's index
    type), values [M], mask [M] float 0/1.

    It also keeps, per (relation domains, domain), the host-built index from
    each entity to the observed cells that touch it (`kernels.entity_cells`),
    and per axis the blocked table's cell order (`cell_orders`,
    `kernels._table_layout`), so a chain builds each once.
    """

    indices: torch.Tensor
    values: torch.Tensor
    mask: torch.Tensor
    entity_cells: Dict[Any, Any] = dataclasses.field(default_factory=dict, repr=False)
    cell_orders: Dict[Any, Any] = dataclasses.field(default_factory=dict, repr=False)


def as_views(views: Sequence, device="cuda") -> Tuple[RelView, ...]:
    """Coerce sparse_ndarray_dataviews (or anything with .indices/.values/
    .mask) into RelViews. Tensors stay on their device; numpy leaves go to
    `device`, the card unless the caller names another. A dataview's
    RelView shares its `entity_cells` and `cell_orders` caches."""
    out = []
    for v in views:
        if isinstance(v, RelView):
            out.append(v)
            continue
        dev = v.indices.device if torch.is_tensor(v.indices) else torch.device(device)
        out.append(RelView(
            torch.as_tensor(v.indices, device=dev).long(),
            torch.as_tensor(v.values, device=dev),
            torch.as_tensor(v.mask, device=dev).float(),
            # a dataview's own caches, so converting it again loses nothing
            getattr(v, "entity_cells", {}),
            getattr(v, "cell_orders", {}),
        ))
    return tuple(out)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class IRMState:
    """Per-domain clustering + per-relation cluster-block suffstats.

      assignments  per domain [N_d] int32
      counts       per domain [K_d] int32
      cluster_hps  per domain {'alpha': 0-d}
      suffstats    per relation, leaves [K_a, K_b, ...]
      hypers       per relation hyper dicts
      lik_names    likelihood registry names, one a relation (static)
      rel_domains  the domain of each axis of each relation (static)
    """

    assignments: Tuple[torch.Tensor, ...]
    counts: Tuple[torch.Tensor, ...]
    cluster_hps: Tuple[Dict[str, torch.Tensor], ...]
    suffstats: Tuple[Dict[str, torch.Tensor], ...]
    hypers: Tuple[Dict[str, torch.Tensor], ...]
    lik_names: Tuple[str, ...] = ()
    rel_domains: Tuple[Tuple[int, ...], ...] = ()

    @property
    def ndomains(self) -> int:
        return len(self.assignments)

    @property
    def device(self) -> torch.device:
        return self.counts[0].device

    def k_max(self, d: int) -> int:
        return self.counts[d].shape[-1]

    def likelihoods(self):
        return tuple(lik_base.get(n) for n in self.lik_names)

    def ngroups(self, d: int):
        return (self.counts[d] > 0).sum(-1)


def _k_maxes(state: IRMState) -> Tuple[int, ...]:
    return tuple(c.shape[-1] for c in state.counts)


def _cell_bins(rel_domains, assignments, indices, k_maxes):
    """Flat cluster-block id per COO cell (row-major over the K grid)."""
    bins = torch.zeros(indices.shape[0], dtype=torch.int64, device=indices.device)
    for axis, dom in enumerate(rel_domains):
        z = assignments[dom][indices[:, axis]]
        bins = bins * k_maxes[dom] + z
    return bins


def _float_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.is_floating_point() else torch.float32


def compute_relation_stats(lik, hyper, rel_domains, assignments, view, k_maxes):
    """Suffstat block tensor [K_a, K_b, ...] from scratch: over chunks of at
    most STATS_CELLS cells (so the sort's memory stays bounded), one sort of
    the chunk's observed cells by flat K-grid block, then an order-fixed
    segment sum a leaf (`utils.segment`), the chunks added in order: no
    atomics and no host read. Masked and padding cells are dropped. A few
    blocks hold most cells once the clusters settle, so the sum is a tree
    (`tree=True`): its time follows the chunk's size, not how the clusters
    split the cells. Each chunk counts one `irm.restat_chunks` under
    `profiling.recording()`."""
    shape = tuple(k_maxes[d] for d in rel_domains)
    total = int(np.prod(shape))
    out = None
    for lo in range(0, max(1, view.indices.shape[0]), STATS_CELLS):
        profiling.count("irm.restat_chunks")
        cut = slice(lo, lo + STATS_CELLS)
        bins = _cell_bins(rel_domains, assignments, view.indices[cut], k_maxes)
        blocks = segment.segments(torch.where(view.mask[cut] > 0, bins, total), total, tree=True)
        part = {k: blocks.sum(t) for k, t in lik.tx(hyper, view.values[cut], view.mask[cut]).items()}
        out = part if out is None else {k: out[k] + part[k] for k in out}
    return {k: v.reshape(*shape, *v.shape[1:]) for k, v in out.items()}


def initialize(
    defn: IRMDefinition,
    views: Sequence,
    generator: torch.Generator,
    cluster_hps: Optional[Sequence[Dict[str, Any]]] = None,
    relation_hps: Optional[Sequence[Dict[str, Any]]] = None,
    domain_assignments: Optional[Sequence] = None,
) -> IRMState:
    """Build an initialized IRM state (irm's state.initialize analog).

    views: one sparse_ndarray_dataview (or RelView) a relation; the state
    lives on their device. domain_assignments: optional explicit [N_d] int
    arrays; otherwise each domain draws from its CRP prior
    (`state.sample_crp_assignment`), domains in order, from `generator`.
    """
    validator.validate_len(views, len(defn.relations), "relation views")
    views = as_views(views)
    device = views[0].indices.device
    dt = _float_dtype(views[0].values)
    hypers = tuple(
        r.model.canonical_hyper(
            None if relation_hps is None else relation_hps[i],
            dtype=_float_dtype(views[i].values), device=device,
        )
        for i, r in enumerate(defn.relations)
    )
    chps = []
    for d in range(defn.ndomains):
        hp = (cluster_hps[d] if cluster_hps is not None else {}) or {}
        alpha = hp.get("alpha", 1.0)
        chps.append({"alpha": torch.as_tensor(np.asarray(alpha), device=device).to(dt)})

    assignments = []
    for d in range(defn.ndomains):
        if domain_assignments is not None and domain_assignments[d] is not None:
            a = torch.as_tensor(np.asarray(domain_assignments[d]), device=device)
        else:
            a = mix_state.sample_crp_assignment(
                generator, defn.domain_sizes[d], defn.k_maxes[d], chps[d]["alpha"])
        assignments.append(a.to(device=device, dtype=torch.int32))
    assignments = tuple(assignments)
    counts = tuple(
        mix_state._assignment_counts(assignments[d], defn.k_maxes[d])
        for d in range(defn.ndomains)
    )
    suffstats = tuple(
        compute_relation_stats(
            r.model.likelihood, hypers[i], r.domains, assignments, views[i],
            defn.k_maxes,
        )
        for i, r in enumerate(defn.relations)
    )
    return IRMState(
        assignments=assignments,
        counts=counts,
        cluster_hps=tuple(chps),
        suffstats=suffstats,
        hypers=hypers,
        lik_names=tuple(r.model.name for r in defn.relations),
        rel_domains=tuple(r.domains for r in defn.relations),
    )


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------
def _crp_eppf(counts, alpha):
    """log EPPF of a partition with these counts; alpha may be a [G] grid."""
    counts_f = counts.to(alpha.dtype)
    active = counts > 0
    n = counts_f.sum()
    return (
        active.sum().to(alpha.dtype) * torch.log(alpha)
        + torch.where(active, torch.lgamma(counts_f), torch.zeros_like(counts_f)).sum()
        + torch.lgamma(alpha)
        - torch.lgamma(alpha + n)
    )


def score_assignment(state: IRMState):
    """Sum over domains of the CRP EPPF (group_manager::score_assignment)."""
    return sum(_crp_eppf(state.counts[d], state.cluster_hps[d]["alpha"])
               for d in range(state.ndomains))


def score_likelihood(state: IRMState, rid: Optional[int] = None):
    """Sum over relations of the marginal loglik of every cluster block.

    Empty blocks carry zero suffstats and score exactly 0 under every
    conjugate marginal, so the sum runs over the whole dense block tensor.
    """
    rids = range(len(state.suffstats)) if rid is None else [rid]
    liks = state.likelihoods()
    return sum(liks[r].marginal_loglik(state.hypers[r], state.suffstats[r]).sum() for r in rids)


def score_joint(state: IRMState):
    """log p(partitions, relations): the enumeration oracle's target."""
    return score_assignment(state) + score_likelihood(state)


# ---------------------------------------------------------------------------
# prediction (link prediction: the IRM posterior-predictive surface)
# ---------------------------------------------------------------------------
def pred_logpdf(state: IRMState, rid, indices, values):
    """Collapsed posterior-predictive log p(x_cell | state) for query cells.

    indices [M, arity] entity tuples of relation `rid`, values [M] candidate
    cell values; each cell is scored against its cluster block's current
    suffstats (the reference irm's score_value analog, used for link
    prediction and missing-cell imputation). Cell values are scalars.
    """
    rid = int(rid)
    lik = state.likelihoods()[rid]
    doms = state.rel_domains[rid]
    k_maxes = _k_maxes(state)
    shape = tuple(k_maxes[d] for d in doms)
    total = int(np.prod(shape))
    indices = torch.as_tensor(indices, device=state.device).long()
    values = torch.as_tensor(values, device=state.device)
    bins = _cell_bins(doms, state.assignments, indices, k_maxes)
    stats_cells = {k: s.reshape(total, *s.shape[len(shape):])[bins]
                   for k, s in state.suffstats[rid].items()}
    return lik.pred_logpdf(state.hypers[rid], stats_cells, values)


def predict_missing(state: IRMState, rid, indices, candidates):
    """Posterior-predictive distribution over `candidates` for each cell.

    Returns [M, C] normalized probabilities: argmax gives the imputation,
    and for binary relations candidates=(0, 1) gives link probabilities.
    """
    m = len(indices)
    logps = torch.stack(
        [pred_logpdf(state, rid, indices, torch.full((m,), float(c), device=state.device))
         for c in np.asarray(candidates)],
        dim=-1,
    )
    return torch.softmax(logps, dim=-1)
