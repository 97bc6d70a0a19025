"""Jain-Neal split-merge MH moves for conjugate DP mixtures (port of
`common_tpu/kernels/splitmerge.py`).

Split-merge (Jain & Neal 2004) is the DPMM mixing multiplier of the JAX
package: single-site sweeps move mass between clusters one row at a time,
while one accepted split or merge relocates a whole cluster.

* The anchor pair (i, j) picks a SPLIT (same cluster) or a MERGE
  (different clusters). The JAX package runs both branches under one
  `lax.cond`; here the branch is a host decision on ci == cj, so a move
  reads the device once: i, j and their clusters in one copy.
* The restricted Gibbs launch scans are blocked: every member row is
  rescored against the two candidate components' suffstats from the
  previous scan in one [N, 2] pass. The proposal density is the product of
  the final blocked scan's per-row conditionals, exactly computable, so
  the MH correction is exact; blocking changes only the proposal's
  quality, never the stationary distribution.
* Acceptance works at partition level: the change of score_joint (EPPF
  and marginal likelihoods, both label-invariant) plus log q_reverse -
  log q_forward, with the merge direction deterministic (q = 1). Slot
  bookkeeping (a split opens the first empty slot, a merge zero-clears
  the emptied one) is pure representation.
* The two-component suffstats come from `blocked.block_stats` with K = 2:
  for an niw feature on the card, sum_xxT by the scatter kernel, one
  launch a rebuild, 5 a merge move and 6 a split move at t_scans = 3
  (the anchor seeding, t_scans scans, the final scan, and a split's
  proposal).

Only conjugate likelihoods (additive suffstats, collapsed predictives);
fixed-K states have no split-merge notion and are rejected. Every function
takes an explicit `torch.Generator` on the state's device and consumes it
in order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from common_tpu_torch.kernels import blocked
from common_tpu_torch.rng import gumbel_argmax, uniform_open
from common_tpu_torch.state import MixtureState

LAUNCH_ROWS = 65536  # rows scored at a time by _launch_table


def _check_support(state: MixtureState):
    if state.fixed:
        raise ValueError("split-merge requires a CRP (non-fixed) state")
    for lik in state.likelihoods():
        if getattr(lik, "latent_leaves", None) or not lik.conjugate:
            raise ValueError(
                f"split-merge requires conjugate likelihoods with additive "
                f"suffstats; got {lik.name}"
            )


def _float_dtype(state: MixtureState) -> torch.dtype:
    return state.cluster_hp["alpha"].dtype


def _member_stats(state: MixtureState, data, member, lab):
    """Two-component suffstats and row counts from launch labels.

    member: [N] bool (rows in the move's scope); lab: [N] int in {0, 1}.
    Returns ([per feature {leaf: [2, ...]}], counts [2] float row counts).
    """
    stats2 = list(blocked.block_stats(state, data, lab, member, K=2))
    counts2 = torch.stack([(member & (lab == 0)).sum(), (member & (lab == 1)).sum()])
    return stats2, counts2.to(_float_dtype(state))


def _launch_table(state: MixtureState, data, stats2, counts2):
    """[N, 2] blocked restricted-Gibbs logits: log n_c + sum_f pred_c.

    Each feature's predictive is factored once, then the rows are scored
    LAUNCH_ROWS at a time (niw's [2, D, rows] deviations stay small).
    """
    lp = torch.log(torch.clamp(counts2, min=1e-6))[None, :]
    liks = state.likelihoods()
    preds = [lik.predictive(h, s2) for lik, h, s2 in zip(liks, state.hypers, stats2)]
    n = data[0][0].shape[0]
    out = []
    for a in range(0, n, LAUNCH_ROWS):
        lp_a = lp
        for (x, mask), lik, pred in zip(data, liks, preds):
            s = lik.predictive_logpdf(pred, x[a:a + LAUNCH_ROWS])
            lp_a = lp_a + s * mask[a:a + LAUNCH_ROWS, None].to(s.dtype)
        out.append(lp_a)
    return torch.cat(out)


def _ml_sum(state: MixtureState, stats_list):
    """Sum over features (and the [2] component axis) of marginal logliks."""
    total = 0.0
    for lik, hyper, s in zip(state.likelihoods(), state.hypers, stats_list):
        total = total + lik.marginal_loglik(hyper, s).sum()
    return total


def _slot_ml(state: MixtureState, slot):
    """Sum over features of the marginal loglik of slot `slot` (0 when empty);
    a list of slots gives the sum over them (one marginal call a feature)."""
    total = 0.0
    for lik, hyper, s in zip(state.likelihoods(), state.hypers, state.stats):
        ml = lik.marginal_loglik(hyper, s)[slot]
        total = total + torch.where(state.counts[slot] > 0, ml, 0.0).sum()
    return total


def _split_terms(state: MixtureState, data, member, free, prop, logq, ci: int):
    """The log-acceptance terms of splitting cluster ci by labels prop [N]:
    (d_ml, d_eppf, log q_forward, the two components' stats, their row counts)."""
    q_fwd = torch.where(free, logq.gather(-1, prop.to(torch.int64)[:, None])[:, 0], 0.0).sum()
    stats2p, _ = _member_stats(state, data, member, prop)
    cnt_a = (member & (prop == 0)).sum().to(logq.dtype)
    cnt_b = (member & (prop == 1)).sum().to(logq.dtype)
    d_ml = _ml_sum(state, stats2p) - _slot_ml(state, ci)
    d_eppf = (torch.log(state.cluster_hp["alpha"]) + torch.lgamma(cnt_a) + torch.lgamma(cnt_b)
              - torch.lgamma(cnt_a + cnt_b))
    return d_ml, d_eppf, q_fwd, stats2p, cnt_a, cnt_b


def _merge_terms(state: MixtureState, z, free, logq, ci: int, cj: int):
    """The log-acceptance terms of merging cluster cj into ci:
    (d_ml, d_eppf, log q_reverse, the merged stats per feature)."""
    orig = (z == cj).to(torch.int64)  # current labels (a = ci)
    q_rev = torch.where(free, logq.gather(-1, orig[:, None])[:, 0], 0.0).sum()
    merged = [{k: v[ci] + v[cj] for k, v in s_f.items()} for s_f in state.stats]
    ml_merged = 0.0
    for lik, hyper, sm in zip(state.likelihoods(), state.hypers, merged):
        ml_merged = ml_merged + lik.marginal_loglik(hyper, sm)
    d_ml = ml_merged - _slot_ml(state, [ci, cj])
    cnt_a = state.counts[ci].to(logq.dtype)
    cnt_b = state.counts[cj].to(logq.dtype)
    d_eppf = (torch.lgamma(cnt_a + cnt_b) - torch.lgamma(cnt_a) - torch.lgamma(cnt_b)
              - torch.log(state.cluster_hp["alpha"]))
    return d_ml, d_eppf, q_rev, merged


def move(state: MixtureState, data, generator: torch.Generator, t_scans: int = 3) -> MixtureState:
    """One split-merge MH move (anchor pair -> launch -> propose -> accept).

    One device read: the anchor rows and their clusters, which pick the
    split or the merge branch on the host. The acceptance is applied on the
    device. `move.proposed` counts the proposals of each kind ("split",
    "merge") since it was last reset.
    """
    _check_support(state)
    n = state.n
    z = state.assignments
    dev = z.device
    i_t = torch.randint(0, n, (1,), generator=generator, device=dev)
    j0 = torch.randint(0, n - 1, (1,), generator=generator, device=dev)
    j_t = j0 + (j0 >= i_t).to(j0.dtype)  # j != i, uniform
    i, j, ci, cj = torch.cat([i_t, j_t, z[i_t].long(), z[j_t].long()]).tolist()
    is_split = ci == cj
    move.proposed["split" if is_split else "merge"] += 1
    member = (z == ci) | (z == cj)
    free = member.clone()
    free[i] = False
    free[j] = False

    # launch: anchor-seeded init, then t_scans blocked restricted scans. A
    # random 50/50 init is a symmetric fixed point of the blocked scan (both
    # components carry near-identical mixture stats), so the first pass is
    # seeded from the two anchor rows alone, as Jain-Neal's sequential
    # launch is.
    lab = torch.ones(n, dtype=torch.int32, device=dev)
    lab[i] = 0
    anchor_only = torch.zeros(n, dtype=torch.bool, device=dev)
    anchor_only[i] = True
    anchor_only[j] = True
    stats0, counts0 = _member_stats(state, data, anchor_only, lab)
    lp0 = _launch_table(state, data, stats0, counts0)
    lab = torch.where(free, gumbel_argmax(lp0, generator).to(torch.int32), lab)
    for _ in range(t_scans):
        stats2, counts2 = _member_stats(state, data, member, lab)
        lp = _launch_table(state, data, stats2, counts2)
        lab = torch.where(free, gumbel_argmax(lp, generator).to(torch.int32), lab)

    # final blocked scan: the proposal density
    stats2, counts2 = _member_stats(state, data, member, lab)
    lp = _launch_table(state, data, stats2, counts2)
    logq = torch.log_softmax(lp, -1)  # [N, 2]

    counts_new = state.counts.clone()
    stats_new = [{k: v.clone() for k, v in s_f.items()} for s_f in state.stats]
    if is_split:
        empty = state.counts == 0
        b_slot = torch.argmax(empty.to(torch.int32)).reshape(1)  # the first empty slot
        prop = torch.where(free, gumbel_argmax(lp, generator).to(torch.int32), lab)  # anchors pinned
        d_ml, d_eppf, q_fwd, stats2p, cnt_a, cnt_b = _split_terms(
            state, data, member, free, prop, logq, ci)
        log_acc = torch.where(empty.any(), d_ml + d_eppf - q_fwd, -math.inf)
        z_new = torch.where(member & (prop == 1), b_slot.to(z.dtype), z)
        counts_new[ci] = cnt_a.to(counts_new.dtype)
        counts_new.index_copy_(0, b_slot, cnt_b.reshape(1).to(counts_new.dtype))
        for s_f, s2 in zip(stats_new, stats2p):
            for k, v in s_f.items():
                v[ci] = s2[k][0]
                v.index_copy_(0, b_slot, s2[k][1:2])
    else:
        d_ml, d_eppf, q_rev, merged = _merge_terms(state, z, free, logq, ci, cj)
        log_acc = d_ml + d_eppf + q_rev
        z_new = torch.where(z == cj, torch.full_like(z, ci), z)
        counts_new[ci] += state.counts[cj]
        counts_new[cj] = 0
        for s_f, sm in zip(stats_new, merged):
            for k, v in s_f.items():
                v[ci] = sm[k]
                v[cj] = 0.0  # the emptied slot: exact zeros

    accept = torch.log(uniform_open((), generator, logq.dtype)) < log_acc
    return dataclasses.replace(
        state,
        assignments=torch.where(accept, z_new, z),
        counts=torch.where(accept, counts_new, state.counts),
        stats=tuple({k: torch.where(accept, s_new[k], v) for k, v in s_old.items()}
                    for s_new, s_old in zip(stats_new, state.stats)),
    )


move.proposed = {"split": 0, "merge": 0}


def moves(state: MixtureState, data, generator: torch.Generator, n_moves: int = 4,
          t_scans: int = 3) -> MixtureState:
    """n_moves sequential split-merge proposals."""
    _check_support(state)
    for _ in range(n_moves):
        state = move(state, data, generator, t_scans=t_scans)
    return state
