"""Clustering state (port of `common_tpu/state.py`).

Reference analogs: ``common:include/microscopes/common/group_manager.hpp``
(CRP assignment vector, per-group counts and suffstats, EPPF scoring) and
``entity_state.hpp``. As in the JAX package, dynamic group birth and death
become a fixed-capacity padded representation: ``assignments[N]``
(-1 = unassigned), ``counts[K_max]`` and per-feature suffstat dicts with a
leading ``[K_max]`` axis. "Create group" touches the first empty slot; a
group dies when its count reaches zero.

Here the state is a dataclass of tensors on one device, which follows the
data; every sampling function takes an explicit `torch.Generator` on that
device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from common_tpu_torch import validator
from common_tpu_torch.likelihoods import base as lik_base
from common_tpu_torch.models import model_descriptor
from common_tpu_torch.ops.slice_update import KIND_CRP, HyperTarget, exponential_rate
from common_tpu_torch.rng import gumbel_argmax


# ---------------------------------------------------------------------------
# definition (model_definition analog -- mixturemodel:.../definition.py)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MixtureDefinition:
    """Problem shape: number of rows, feature models, cluster capacity."""

    n: int
    models: Tuple[model_descriptor, ...]
    k_max: int

    def __post_init__(self):
        validator.validate_positive(self.n, "n")
        validator.validate_positive(self.k_max, "k_max")
        validator.validate_nonempty(self.models, "models")
        object.__setattr__(self, "models", tuple(self.models))

    @property
    def nfeatures(self) -> int:
        return len(self.models)

    def likelihoods(self):
        return tuple(m.likelihood for m in self.models)


def model_definition(n: int, models: Sequence[model_descriptor], k_max: int = 64):
    """Reference-parity constructor (mixturemodel's ``model_definition``)."""
    return MixtureDefinition(n, tuple(models), k_max)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MixtureState:
    """Padded-K clustering state (group_manager + per-feature suffstats).

      assignments [N] int32, -1 = unassigned
      counts      [K] int32, rows per cluster (0 = empty slot)
      cluster_hp  dict: {'alpha': scalar} CRP, or {'alphas': [K]} fixed-K
      stats       tuple over features of suffstat dicts, leaves [K, ...]
      hypers      tuple over features of hyper dicts
      lik_names   likelihood registry names, one per feature
      fixed       True = fixed-K Dirichlet prior (fixed_group_manager)
    """

    assignments: torch.Tensor
    counts: torch.Tensor
    cluster_hp: Dict[str, torch.Tensor]
    stats: Tuple[Dict[str, torch.Tensor], ...]
    hypers: Tuple[Dict[str, torch.Tensor], ...]
    lik_names: Tuple[str, ...] = ()
    fixed: bool = False

    @property
    def n(self) -> int:
        return self.assignments.shape[-1]

    @property
    def k_max(self) -> int:
        return self.counts.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.counts.device

    def nentities(self) -> int:
        return self.n

    def ngroups(self):
        return (self.counts > 0).sum(-1)

    def groups(self):
        """Active group ids (host-side)."""
        return np.nonzero(self.counts.cpu().numpy() > 0)[0]

    def empty_groups(self):
        return np.nonzero(self.counts.cpu().numpy() == 0)[0]

    def likelihoods(self):
        return tuple(lik_base.get(n) for n in self.lik_names)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------
def _float_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.is_floating_point() else torch.float32


def compute_stats(defn: MixtureDefinition, hypers, data, assignments):
    """Per-feature suffstats from scratch; unassigned rows (gid -1) drop."""
    K = defn.k_max
    gid = torch.where(assignments >= 0, assignments, K)
    return tuple(
        desc.likelihood.stats_from_assignments(hyper, x, mask, gid, K)
        for (x, mask), desc, hyper in zip(data, defn.models, hypers)
    )


def _assignment_counts(assignments, k_max):
    """[k_max] int32 rows per slot; ids outside [0, k_max) are not counted.

    A scatter-add into k_max + 1 bins, since `torch.bincount` waits for
    the device to size its output.
    """
    gid = torch.where((assignments >= 0) & (assignments < k_max), assignments, k_max)
    counts = torch.zeros(k_max + 1, dtype=torch.int64, device=assignments.device)
    counts.scatter_add_(0, gid.long(), torch.ones_like(gid, dtype=torch.int64))
    return counts[:k_max].to(torch.int32)


def initialize(
    defn: MixtureDefinition,
    data,
    generator: torch.Generator,
    cluster_hp: Optional[Dict[str, Any]] = None,
    feature_hps: Optional[Sequence[Dict[str, Any]]] = None,
    assignment=None,
    fixed: bool = False,
) -> MixtureState:
    """Build an initialized state (reference: state.initialize(defn, view, rng)).

    data: ((values [N, ...], mask [N]), ...) tensors on one device; the
    state lives there and its float type follows the first column's.
    assignment: None samples from the CRP prior (capped at k_max);
    otherwise an [N] int array of group ids.
    """
    validator.validate_len(data, defn.nfeatures, "data columns")
    x0 = data[0][0]
    device, dt = x0.device, _float_dtype(x0)
    hypers = tuple(
        desc.canonical_hyper(
            None if feature_hps is None else feature_hps[f],
            dtype=_float_dtype(x), device=device,
        )
        for f, (desc, (x, _)) in enumerate(zip(defn.models, data))
    )
    chp = cluster_hp or {}
    if fixed:
        alphas = chp.get("alphas", np.ones(defn.k_max, np.float32))
        cluster = {"alphas": torch.as_tensor(np.asarray(alphas), device=device).to(dt)}
    else:
        cluster = {"alpha": torch.as_tensor(np.asarray(chp.get("alpha", 1.0)), device=device).to(dt)}

    if assignment is None:
        alpha = 1.0 if fixed else cluster["alpha"]
        assignment = sample_crp_assignment(generator, defn.n, defn.k_max, alpha)
    assignment = torch.as_tensor(assignment, device=device).to(torch.int32)

    return MixtureState(
        assignments=assignment,
        counts=_assignment_counts(assignment, defn.k_max),
        cluster_hp=cluster,
        stats=compute_stats(defn, hypers, data, assignment),
        hypers=hypers,
        lik_names=tuple(m.name for m in defn.models),
        fixed=fixed,
    )


def sample_crp_assignment(generator: torch.Generator, n: int, k_max: int, alpha):
    """Sequential CRP prior draw, capped at k_max tables: [n] int32.

    A host-side loop (the JAX package scans on the device). Row i copies
    the table of a uniformly chosen earlier row with probability
    i / (i + alpha), which seats it at table k with probability
    n_k / (i + alpha), and opens the next table otherwise; once all k_max
    tables are open it always copies. Tables open in order, so the open
    ones are always 0 .. m-1, as in the JAX version's first-empty-slot rule.
    """
    validator.validate_positive(n, "n")
    alpha = float(alpha)
    u = torch.rand((2, n), generator=generator, device=generator.device, dtype=torch.float64)
    pick, seat = u.cpu().tolist()
    z = [0] * n
    m = 1  # row 0 opens table 0
    for i in range(1, n):
        w = alpha if m < k_max else 0.0
        if seat[i] * (i + w) < i:
            z[i] = z[int(pick[i] * i)]
        else:
            z[i] = m
            m += 1
    return torch.tensor(z, dtype=torch.int32, device=generator.device)


# ---------------------------------------------------------------------------
# entity ops (entity_based_state_object analog)
# ---------------------------------------------------------------------------
def working_copy(state: MixtureState) -> MixtureState:
    """A state whose assignments, counts and stats are fresh copies.

    The collapsed sweeps update such a copy in place, row by row, and leave
    the caller's state unchanged. Hypers and cluster hypers are shared: no
    entity op writes them.
    """
    return dataclasses.replace(
        state,
        assignments=state.assignments.clone(),
        counts=state.counts.clone(),
        stats=tuple({k: v.clone() for k, v in s.items()} for s in state.stats),
    )


def _row_txs(state: MixtureState, data, eid: int):
    """Suffstat contributions of row `eid` for every feature."""
    return [
        lik.tx(hyper, x[eid], mask[eid])
        for (x, mask), lik, hyper in zip(data, state.likelihoods(), state.hypers)
    ]


def slot_hypers(state: MixtureState):
    """The hypers, shaped to broadcast against the [..., K, ...] stats: a
    stack's [P, ...] leaves lifted to [P, 1, ...]; one state's as they are."""
    if state.counts.dim() == 1:
        return state.hypers
    return tuple({k: v.unsqueeze(1) for k, v in h.items()} for h in state.hypers)


def _flat_slots(state: MixtureState, slot):
    """(slot as indices [M] into the flattened [..., K] slot axes, counts and
    stats with those axes flattened, as views). One state: M = 1 and the
    state's own tensors. A stack of P states: slot [P], one a state, and
    M = P."""
    if state.counts.dim() == 1:
        return slot, state.counts, state.stats
    n_p, k = state.counts.shape
    flat = slot + k * torch.arange(n_p, device=state.device)
    stats = tuple({key: v.view(n_p * k, *v.shape[2:]) for key, v in s.items()} for s in state.stats)
    return flat, state.counts.view(-1), stats


def remove_value_(state: MixtureState, data, eid: int) -> MixtureState:
    """Unassign row `eid` in place: downdate counts and suffstats, and
    zero-clear a slot the row leaves empty. Also unassigns it in every
    state of a stack (`parallel.stack_states`) at once.

    `eid` is a Python int; the row's old slot stays a device tensor, so
    nothing here waits for the device.
    """
    old = state.assignments[..., eid]
    present = old >= 0
    idx, counts, stats = _flat_slots(state, lik_base._slot(old.clamp(min=0), state.device))
    present = present.reshape(-1)
    counts.index_add_(0, idx, -present.to(counts.dtype))
    emptied = (counts.index_select(0, idx) == 0) & present
    for txf, stats_f in zip(_row_txs(state, data, eid), stats):
        sign = -present.to(next(iter(stats_f.values())).dtype)
        lik_base.scatter_fold_(stats_f, idx, txf, sign)
        lik_base.zero_slot_(stats_f, idx, ~emptied)
    state.assignments[..., eid].fill_(-1)  # `[eid] = -1` would copy the -1 from the host and wait
    return state


def add_value_(state: MixtureState, data, eid: int, gid) -> MixtureState:
    """Assign row `eid` to slot `gid` (an int or a 0-d device tensor) in
    place; in a stack of P states, row `eid` of state p to slot gid[p]."""
    slot = lik_base._slot(gid, state.device)
    idx, counts, stats = _flat_slots(state, slot)
    for txf, stats_f in zip(_row_txs(state, data, eid), stats):
        lik_base.scatter_fold_(stats_f, idx, txf, 1.0)
    state.assignments[..., eid] = slot.reshape(state.assignments.shape[:-1])
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=counts.dtype))
    return state


def remove_value(state: MixtureState, data, eid: int) -> MixtureState:
    """Unassign row eid: downdate counts + suffstats; zero-clear emptied slot."""
    return remove_value_(working_copy(state), data, eid)


def add_value(state: MixtureState, data, eid: int, gid) -> MixtureState:
    """Assign row eid to group gid: update counts + suffstats."""
    return add_value_(working_copy(state), data, eid, gid)


def repad(state: MixtureState, new_k_max: int) -> MixtureState:
    """K_max growth: pad every cluster-axis leaf with empty slots.

    Returns an equivalent state with capacity `new_k_max`; pair it with
    ``dataclasses.replace(defn, k_max=new_k_max)`` for the definition.
    """
    validator.validate_positive(new_k_max, "new_k_max")
    k_old = state.k_max
    if new_k_max < k_old:
        raise ValueError(f"new_k_max ({new_k_max}) must be >= current k_max ({k_old})")
    if state.fixed:
        raise ValueError("fixed-K states have exactly K components; cannot repad")
    if new_k_max == k_old:
        return state

    def pad(leaf):
        extra = torch.zeros((new_k_max - k_old, *leaf.shape[1:]), dtype=leaf.dtype, device=leaf.device)
        return torch.cat([leaf, extra])

    return dataclasses.replace(
        state,
        counts=pad(state.counts),
        stats=tuple({k: pad(v) for k, v in s.items()} for s in state.stats),
    )


def pred_scores(state: MixtureState, data, eid: int):
    """[K] sum over features of row eid's posterior-predictive log density
    in each slot, masked cells 0 ([P, K] for a stack of P states)."""
    total = None
    for (x, mask), lik, hyper, stats_f in zip(data, state.likelihoods(), slot_hypers(state), state.stats):
        s = lik.pred_logpdf(hyper, stats_f, x[eid])
        s = s * mask[eid].to(s.dtype)
        total = s if total is None else total + s
    return total


def score_value(state: MixtureState, data, eid: int):
    """[K] log p(assign row eid to each slot): CRP prior + likelihoods
    ([P, K] for a stack of P states)."""
    return crp_prior_scores(state) + pred_scores(state, data, eid)


# ---------------------------------------------------------------------------
# generative surfaces (mixturemodel's sample / sample_post_pred)
# ---------------------------------------------------------------------------
def _draw_rows(lik, generator, hyper, stats, z):
    """One value per entry of z from each slot's parameter draw."""
    theta = lik.sample_params(generator, hyper, stats)
    rows = {k: v.index_select(0, z) for k, v in theta.items()}
    n = z.shape[0]
    return lik.sample_value(generator, rows), torch.ones(n, dtype=torch.float32, device=z.device)


def sample(
    defn: MixtureDefinition,
    generator: torch.Generator,
    cluster_hp: Optional[Dict[str, Any]] = None,
    feature_hps: Optional[Sequence[Dict[str, Any]]] = None,
):
    """Synthetic data from the model prior (mixturemodel's ``sample``): a
    CRP partition, per-cluster parameters from each feature prior, then one
    row per entity, on the generator's device. Returns (data columns,
    assignment) in the ((values, mask), ...) layout `initialize` consumes.
    """
    dev = generator.device
    hypers = tuple(
        desc.canonical_hyper(None if feature_hps is None else feature_hps[f], device=dev)
        for f, desc in enumerate(defn.models)
    )
    z = sample_crp_assignment(generator, defn.n, defn.k_max, (cluster_hp or {}).get("alpha", 1.0))
    data = tuple(
        _draw_rows(desc.likelihood, generator, hyper,
                   desc.likelihood.init_stats(hyper, (defn.k_max,)), z.long())
        for desc, hyper in zip(defn.models, hypers)
    )
    return data, z


def sample_post_pred(state: MixtureState, generator: torch.Generator, size: int = 1):
    """Draw `size` hypothetical new rows from the posterior predictive
    (mixturemodel's ``state.sample_post_pred``): cluster ~ CRP seating
    weights (a fresh cluster takes the alpha slot and draws from the
    prior), then a value from that cluster's posterior parameter draw.
    Returns (data columns, cluster ids [size]).
    """
    validator.validate_positive(size, "size")
    logw = crp_prior_scores(state)
    z = gumbel_argmax(logw.expand(size, state.k_max), generator)
    data = tuple(
        _draw_rows(lik, generator, hyper, stats_f, z)
        for lik, hyper, stats_f in zip(state.likelihoods(), state.hypers, state.stats)
    )
    return data, z


# ---------------------------------------------------------------------------
# scores
# ---------------------------------------------------------------------------
def crp_prior_scores(state: MixtureState):
    """Per-slot log prior weight for seating a new row ([K], -inf = invalid).

    CRP: log n_k for active slots; log alpha on the first empty slot.
    Fixed-K Dirichlet: log(n_k + alpha_k) on every slot.
    Batched over leading axes: a [P, K] particle stack scores [P, K].
    """
    if state.fixed:
        alphas = state.cluster_hp["alphas"]
        return torch.log(state.counts.to(alphas.dtype) + alphas)
    alpha = state.cluster_hp["alpha"]
    counts_f = state.counts.to(alpha.dtype)
    active = state.counts > 0
    crp = torch.where(active, torch.log(counts_f), torch.full_like(counts_f, -torch.inf))
    empty = (~active).to(torch.int32)
    can_open = empty.any(-1, keepdim=True)
    first_empty = torch.argmax(empty, dim=-1, keepdim=True)
    k = torch.arange(state.k_max, device=state.device)
    return torch.where((k == first_empty) & can_open, torch.log(alpha)[..., None], crp)


def is_saturated(state: MixtureState):
    """True when every K_max slot is occupied (no empty slot to open).

    A CRP state with all slots active stops proposing new clusters; the
    samplers stay valid on the truncated support, but the truncation is no
    longer negligible. Fixed-K states are never saturated.
    """
    if state.fixed:
        return torch.tensor(False)
    return (state.counts > 0).all()


def score_assignment(state: MixtureState):
    """EPPF: log p(partition) (group_manager::score_assignment).

    CRP:  K+ log alpha + sum_k lgamma(n_k) + lgamma(alpha) - lgamma(alpha + N)
    Fixed-K: Dirichlet-multinomial over assignment counts.
    """
    if state.fixed:
        a = state.cluster_hp["alphas"]
        counts_f = state.counts.to(a.dtype)
        n = counts_f.sum()
        a0 = a.sum()
        return (
            (torch.lgamma(a + counts_f) - torch.lgamma(a)).sum()
            + torch.lgamma(a0)
            - torch.lgamma(a0 + n)
        )
    alpha = state.cluster_hp["alpha"]
    counts_f = state.counts.to(alpha.dtype)
    n = counts_f.sum()
    active = state.counts > 0
    kplus = active.sum().to(alpha.dtype)
    return (
        kplus * torch.log(alpha)
        + torch.where(active, torch.lgamma(counts_f), torch.zeros_like(counts_f)).sum()
        + torch.lgamma(alpha)
        - torch.lgamma(alpha + n)
    )


def crp_hyper_target(state: MixtureState, prior) -> Optional[HyperTarget]:
    """The `ops.slice_update.HyperTarget` of the CRP concentration under
    `prior`: the part of `score_assignment` that moves with alpha, plus the
    prior. None for a fixed-K state or a prior or dtype the target cannot
    take (`kernels/slice_.py` `hp` then scores `score_assignment` in its
    host loop)."""
    if state.fixed:
        return None
    rate = exponential_rate(prior, state.cluster_hp["alpha"])
    return None if rate is None else HyperTarget(KIND_CRP, rate, state.counts)


def score_likelihood(state: MixtureState, fid: Optional[int] = None):
    """Sum over active groups of each feature's marginal loglik (score_data).

    fid=None sums over all features.
    """
    active = state.counts > 0
    fids = range(len(state.stats)) if fid is None else [fid]
    liks = state.likelihoods()
    total = 0.0
    for f in fids:
        ml = liks[f].marginal_loglik(state.hypers[f], state.stats[f])
        total = total + torch.where(active, ml, torch.zeros_like(ml)).sum()
    return total


def score_joint(state: MixtureState):
    """log p(partition, data): the enumeration oracle's target."""
    return score_assignment(state) + score_likelihood(state)


HELDOUT_BATCH = 1024  # rows scored at a time by heldout_logp


def heldout_logp(state: MixtureState, data):
    """[n] log posterior-predictive density of held-out rows.

        log p(x* | state) = logsumexp_k(log w_k + sum_f pred_logpdf_{k,f})
                            - logsumexp_k(log w_k)

    with w_k the CRP/Dirichlet seating weights (`crp_prior_scores`) and
    each feature's collapsed predictive (Student-t for NIW). Each feature's
    predictive is factored once for the state; the rows are then scored
    HELDOUT_BATCH at a time. Masked cells contribute nothing.
    """
    batch = HELDOUT_BATCH
    logw = crp_prior_scores(state)  # [K]
    norm = torch.logsumexp(logw, dim=0)
    liks = state.likelihoods()
    preds = [lik.predictive(h, s) for lik, h, s in zip(liks, state.hypers, state.stats)]
    n = data[0][0].shape[0]
    out = []
    for start in range(0, n, batch):
        lp = logw
        for (x, mask), lik, pred in zip(data, liks, preds):
            s = lik.predictive_logpdf(pred, x[start:start + batch])  # [b, K]
            lp = lp + s * mask[start:start + batch, None].to(s.dtype)
        out.append(torch.logsumexp(lp, dim=-1) - norm)
    return torch.cat(out)
