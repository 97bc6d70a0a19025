"""Collapsed Gibbs kernels for DP mixture states (port of `common_tpu/kernels/gibbs.py`).

Reference analog: `kernels:microscopes/kernels/gibbs.pyx`:
  gibbs.assign(state, rng)              collapsed Gibbs (conjugate models)
  gibbs.assign_resample(state, m, rng)  Neal (2000) algorithm 8, m aux groups
  gibbs.hp(state, specs, rng)           grid Gibbs over feature hypers
  gibbs.assign_fixed(state, rng)        fixed-K variant

Each row step is one vectorized pass over all K_max slots (CRP weights plus
every feature's batched posterior predictive), a Gumbel-argmax choice and a
scatter update of the suffstats. The JAX package scans the rows inside one
compiled program; here the sweep is a Python loop over rows. A sweep works
on one copy of the state (`state.working_copy`) that it updates in place,
so the caller's state is unchanged and no [K, ...] leaf is reallocated per
row. No row step waits for the device: the row index is a Python int, the
slots it touches stay device tensors used as indices, and the Gumbel noise
of a block of rows is drawn at once. All functions take an explicit
`torch.Generator` on the state's device and consume it in order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from common_tpu_torch import state as state_mod
from common_tpu_torch.rng import beta, gumbel, gumbel_argmax, standard_gamma, uniform_open
from common_tpu_torch.state import MixtureState

NOISE_ROWS = 4096  # rows whose Gumbel noise is drawn in one call


def _float_dtype(state: MixtureState) -> torch.dtype:
    return next(iter(state.cluster_hp.values())).dtype


def _aux_slot_mask(counts, m: int):
    """Mask of the first m empty slots (Neal-8 auxiliary groups)."""
    empty = counts == 0
    rank = torch.cumsum(empty.to(torch.int32), -1)
    return empty & (rank <= m)


def _row_sweep_step(data, m: int, generator: torch.Generator, state: MixtureState,
                    eid: int, noise: torch.Tensor):
    """One row of a collapsed-Gibbs sweep (remove, score, sample, add), in
    place on `state`, a working copy. `noise` is the row's [K] Gumbel draw.
    Returns (state, the chosen slot as a 0-d device tensor).

    A stack of P states (`parallel.stack_states`) takes [P, K] noise and
    moves row `eid` in every state at once; the slot is then [P].
    """
    st = state_mod.remove_value_(state, data, eid)
    liks = st.likelihoods()
    hypers = state_mod.slot_hypers(st)
    aux = _aux_slot_mask(st.counts, m)

    # non-conjugate models: fresh prior draws on the aux slots (Neal-8)
    for lik, hyper, stats_f in zip(liks, hypers, st.stats):
        if not lik.conjugate:
            stats_f.update(lik.refresh_latents(generator, hyper, stats_f, aux))

    # seat-choice log-weights over all K slots
    if st.fixed:
        logp = state_mod.crp_prior_scores(st)
    else:
        alpha = st.cluster_hp["alpha"][..., None]
        counts_f = st.counts.to(alpha.dtype)
        neg_inf = torch.full_like(counts_f, -math.inf)
        logp = torch.where(
            st.counts > 0,
            torch.log(counts_f),
            torch.where(aux, torch.log(alpha) - math.log(m), neg_inf),
        )
    logp = logp + state_mod.pred_scores(st, data, eid)

    gid = torch.argmax(logp + noise, dim=-1)
    state_mod.add_value_(st, data, eid, gid)
    return st, gid


def assign_resample(state: MixtureState, data, generator: torch.Generator, m: int = 1) -> MixtureState:
    """One full sweep of Neal algorithm 8 with m auxiliary groups.

    With m=1 and conjugate likelihoods this is exact collapsed Gibbs (the
    aux slot's zero suffstats give the prior predictive and weight alpha/1),
    so `assign` delegates here.
    """
    st = state_mod.working_copy(state)
    n, k = st.n, st.k_max
    dt = _float_dtype(st)
    for start in range(0, n, NOISE_ROWS):
        noise = gumbel((min(NOISE_ROWS, n - start), k), generator, dt)
        for i in range(noise.shape[0]):
            _row_sweep_step(data, m, generator, st, start + i, noise[i])
    return st


def assign(state: MixtureState, data, generator: torch.Generator) -> MixtureState:
    """One collapsed-Gibbs sweep over all rows (kernels' gibbs.assign)."""
    return assign_resample(state, data, generator, m=1)


def assign_fixed(state: MixtureState, data, generator: torch.Generator) -> MixtureState:
    """Fixed-K collapsed Gibbs sweep (gibbs.assign_fixed)."""
    if not state.fixed:
        raise ValueError("assign_fixed requires a fixed-K state")
    return assign_resample(state, data, generator, m=1)


# ---------------------------------------------------------------------------
# grid Gibbs over hyperparameters (kernels' gibbs.hp)
# ---------------------------------------------------------------------------
def _grid_pick(stacked: Dict[str, torch.Tensor], logps: torch.Tensor, generator):
    """One grid point drawn from softmax(logps), as a hyper dict; no host wait."""
    pick = gumbel_argmax(logps, generator).reshape(1)
    return {k: v.index_select(0, pick)[0] for k, v in stacked.items()}


def hp_grid_scores(state: MixtureState, fid: int, grid: Sequence[Dict[str, Any]], prior_fn: Callable):
    """[G] log prior(h) + sum over active slots of marginal_loglik(h, stats),
    one score per grid point h, and the grid stacked on a leading [G] axis.

    The marginal likelihood of all G points comes from one batched call:
    each hyper leaf [G, ...] is lifted to [G, 1, ...] against the [K, ...]
    stats. The prior is evaluated per grid point.
    """
    lik = state.likelihoods()[fid]
    stats = state.stats[fid]
    dt = next(iter(stats.values())).dtype
    points = [lik.validate_hyper(h, dtype=dt, device=state.device) for h in grid]
    stacked = {k: torch.stack([p[k] for p in points]) for k in points[0]}
    ml = lik.marginal_loglik({k: v.unsqueeze(1) for k, v in stacked.items()}, stats)  # [G, K]
    prior = torch.stack([torch.as_tensor(prior_fn(p)).to(ml.dtype) for p in points])
    return prior + torch.where(state.counts > 0, ml, torch.zeros_like(ml)).sum(-1), stacked


def hp(state: MixtureState, specs: Dict[int, Dict[str, Any]], generator: torch.Generator) -> MixtureState:
    """Grid Gibbs over feature hyperparameters.

    specs: {fid: {'prior': callable(hyper_dict)->logp, 'grid': [hyper dicts]}},
    the reference's {fid: {'hpdf': ..., 'hgrid': [...]}} (kernels:gibbs.pyx
    hp kernel): for each feature, score every grid point by prior(h) + sum
    over active slots of marginal_loglik(h, stats), then draw the new hyper
    from the normalized grid posterior. Features go in sorted order.
    """
    new_hypers = list(state.hypers)
    for fid in sorted(specs):
        logps, stacked = hp_grid_scores(state, fid, list(specs[fid]["grid"]), specs[fid]["prior"])
        new_hypers[fid] = _grid_pick(stacked, logps, generator)
    return dataclasses.replace(state, hypers=tuple(new_hypers))


def theta(state: MixtureState, generator: torch.Generator) -> MixtureState:
    """Resample explicit per-cluster latents from their exact conditionals.

    For non-conjugate likelihoods carrying latents inside their suffstats
    (bbnc's p), redraw theta | data for every slot from `sample_params`.
    Conjugate features are untouched. `kernels/slice_.py` `theta` is the
    slice-sampling variant, for latents without a closed conditional.
    """
    new_stats = []
    for lik, hyper, stats_f in zip(state.likelihoods(), state.hypers, state.stats):
        if lik.conjugate or not lik.latent_leaves:
            new_stats.append(stats_f)
            continue
        drawn = lik.sample_params(generator, hyper, stats_f)
        new_stats.append({k: (drawn[k] if k in lik.latent_leaves else v) for k, v in stats_f.items()})
    return dataclasses.replace(state, stats=tuple(new_stats))


def escobar_west_odds(kplus, n, log_eta, a: float = 1.0, b: float = 1.0):
    """Odds of the Gamma(a + K+, .) component in the Escobar-West mixture."""
    return (a + kplus - 1.0) / (n * (b - log_eta))


def cluster_hp_escobar_west(state: MixtureState, generator: torch.Generator,
                            a: float = 1.0, b: float = 1.0) -> MixtureState:
    """Exact auxiliary-variable Gibbs for the CRP concentration alpha
    (Escobar & West 1995, section 6) under an alpha ~ Gamma(a, b) prior:

      eta ~ Beta(alpha + 1, n);  pi = (a + K+ - 1) / (a + K+ - 1 + n (b - log eta));
      alpha ~ pi Gamma(a + K+, b - log eta) + (1 - pi) Gamma(a + K+ - 1, b - log eta).
    """
    alpha = state.cluster_hp["alpha"]
    n = state.counts.sum().to(alpha.dtype)
    kplus = (state.counts > 0).sum().to(alpha.dtype)
    eta = beta(alpha + 1.0, n, generator)
    log_eta = torch.log(torch.clamp(eta, min=1e-30))
    odds = escobar_west_odds(kplus, n, log_eta, a, b)
    pick_high = uniform_open((), generator, alpha.dtype) < odds / (1.0 + odds)
    shape = torch.where(pick_high, a + kplus, a + kplus - 1.0)
    new_alpha = standard_gamma(shape, generator) / (b - log_eta)
    return dataclasses.replace(state, cluster_hp={"alpha": new_alpha.to(alpha.dtype)})


def cluster_hp_grid_scores(state: MixtureState, prior_fn: Callable, grid):
    """[G] log prior(alpha) + EPPF of the current partition, per grid alpha,
    and the grid as a tensor on the state's device."""
    alpha = state.cluster_hp["alpha"]
    g = torch.as_tensor(np.asarray(grid), device=state.device).to(alpha.dtype)
    st = dataclasses.replace(state, cluster_hp={"alpha": g})
    return prior_fn(g).to(alpha.dtype) + state_mod.score_assignment(st), g


def cluster_hp(state: MixtureState, prior_fn: Callable, grid, generator: torch.Generator) -> MixtureState:
    """Grid Gibbs over the CRP concentration alpha (cluster-hp kernel).

    grid: [G] alpha values; prior_fn(alpha) -> logp, elementwise. Scores each
    grid point by prior + EPPF of the current partition, all at once.
    """
    logps, g = cluster_hp_grid_scores(state, prior_fn, grid)
    return dataclasses.replace(state, cluster_hp=_grid_pick({"alpha": g}, logps, generator))
