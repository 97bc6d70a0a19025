"""Sequential Monte Carlo for DP mixtures (port of `common_tpu/kernels/smc.py`, one device).

Sequential imputation with the optimal one-step proposal (the classic SIS
scheme for CRP mixtures, cf. MacEachern-Clyde-Liu 1999): particles are
partial clustering states; rows are absorbed in order; each particle
seats row n from its exact conditional softmax(CRP prior + predictive),
and its weight gains the row's predictive log p(x_n | x_<n, particle) =
logsumexp(scores) - log(alpha + n). Adaptive systematic resampling fires
when ESS < threshold * P, optionally followed by collapsed-Gibbs
rejuvenation of already-seated rows. The running sum of the pre-reset
mean weights is an unbiased (in Z) estimate of the marginal likelihood.
`run_blocked` is the config-5 path: rows in blocks through the blocked
(truncated stick-breaking) conditional with Rao-Blackwellised weights, a
row-sequential warmup and blocked-Gibbs rejuvenation (see its docstring).

Particles are a stacked state (`parallel.stack_states`): every tensor has
a leading [P] axis, and the P particles move in lock-step through batched
tensor ops, the hypers lifted to [P, 1, ...] against the [P, K, ...]
stats (as `blocked.sweep_chains` lifts them), never a Python loop over
particles. Resampling is an `index_select` over that axis. Row steps
update the run's own copy of the particle tensors in place, through the
state's entity ops and the collapsed row step (`state.add_value_`,
`gibbs._row_sweep_step`), which take a stack.

Host reads: each step decides whether to resample from the ESS on the
device, one device read a step (a row in `run`, a warmup row or a block in
`run_blocked`). Row indices (`run`'s rejuvenation rows, `run_blocked`'s
rejuvenation windows) are Python ints from a CPU generator seeded once
from `generator` (`rng.host_generator`): the entity ops take a row as an
int. Every function takes an explicit `torch.Generator` on the particles'
device and consumes it in order; the JAX package's `fold_in` key tree is
not reproduced, so the streams differ by design. Under
`utils.profiling.recording()` the ESS read is `read.smc.ess`, and
`run_blocked` records the spans `smc.pass`, `smc.warmup_step` (a warm-up
row with its resampling check and rejuvenation) and `smc.block_step` (a
block's seating, resampling check and rejuvenation), each step's phases
`smc.seat`, `smc.resample` and `smc.rejuv`.

Particle sharding (`make_particle_mesh`, `shard_particles`, `run_sharded`,
`run_blocked_sharded`): each process of a `torch.distributed` job advances
its P / W particles with the same steps as `run` and `run_blocked`
(kernel 2 on their NIW suffstat rebuilds on the card). At a resampling
check the [P] log-weights are all-gathered; rank 0 takes the ESS decision
and draws the parent indices from its generator exactly as the one-device
run does, and broadcasts both, so every rank resamples alike. Particle
state moves by an all_gather of every tensor and a local index, as in the
JAX package. Rank 0 runs on the caller's generator and every other rank on
one seeded from it and its rank, so ranks given equally seeded generators
still draw apart; at world size 1 the sharded runs equal the one-device
runs bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from common_tpu_torch import state as state_mod
from common_tpu_torch import validator
from common_tpu_torch.kernels import blocked, gibbs
from common_tpu_torch.parallel import mesh as mesh_mod
from common_tpu_torch.parallel.chains import map_tensors, stack_states
from common_tpu_torch.rng import gumbel, gumbel_argmax, host_generator
from common_tpu_torch.state import MixtureState
from common_tpu_torch.utils import profiling


# ---------------------------------------------------------------------------
# weights / resampling
# ---------------------------------------------------------------------------
def log_ess(log_w):
    """log effective sample size of unnormalized log-weights."""
    return 2.0 * torch.logsumexp(log_w, -1) - torch.logsumexp(2.0 * log_w, -1)


def systematic_resample(generator: torch.Generator, log_w):
    """Systematic resampling: [P] parent indices from one uniform draw."""
    p = log_w.shape[-1]
    cdf = torch.cumsum(torch.softmax(log_w, -1), -1)
    u = torch.rand((), generator=generator, device=log_w.device, dtype=log_w.dtype)
    pos = (u + torch.arange(p, device=log_w.device, dtype=log_w.dtype)) / p
    return torch.searchsorted(cdf, pos).clamp(0, p - 1)


def _gather_particles(particles: MixtureState, idx) -> MixtureState:
    """The particles at indices idx [M] of the stack (a new stack of M)."""
    return map_tensors(lambda t: t.index_select(0, idx), particles)


# ---------------------------------------------------------------------------
# particle initialization
# ---------------------------------------------------------------------------
def init_particles(
    defn,
    data,
    generator: torch.Generator,
    n_particles: int,
    cluster_hp: Optional[Dict[str, Any]] = None,
    feature_hps: Optional[Sequence[Dict[str, Any]]] = None,
    fixed: bool = False,
) -> MixtureState:
    """P empty particles (no rows seated): one empty state, stacked P times."""
    validator.validate_positive(n_particles, "n_particles")
    empty = state_mod.initialize(
        defn, data, generator, cluster_hp=cluster_hp, feature_hps=feature_hps,
        assignment=-np.ones(defn.n, np.int32), fixed=fixed,
    )
    return stack_states([empty] * n_particles)


# ---------------------------------------------------------------------------
# row steps on a particle stack, in place (the state's entity ops and
# collapsed row step, which take a stack)
# ---------------------------------------------------------------------------
def _seat_row(parts: MixtureState, data, eid: int, t: float, generator):
    """Seat row eid in every particle, in place; returns the [P] predictive log p."""
    logp = state_mod.score_value(parts, data, eid)  # [P, K]
    state_mod.add_value_(parts, data, eid, gumbel_argmax(logp, generator))
    if parts.fixed:
        norm = parts.cluster_hp["alphas"].sum(-1) + t
    else:
        norm = parts.cluster_hp["alpha"] + t
    return torch.logsumexp(logp, -1) - torch.log(norm)


def _rejuvenate(parts: MixtureState, data, generator, host, eid: int, n_moves: int) -> None:
    """n_moves collapsed-Gibbs updates of random already-seated rows, in place.

    The rows come from the host generator, one a move shared by all
    particles: each particle's move is still a collapsed-Gibbs update of a
    uniformly chosen seated row, which leaves its target invariant.
    """
    rows = torch.randint(0, max(eid + 1, 1), (n_moves,), generator=host).tolist()
    dt = gibbs._float_dtype(parts)
    for row in rows:
        gibbs._row_sweep_step(data, 1, generator, parts, row, gumbel(parts.counts.shape, generator, dt))


# ---------------------------------------------------------------------------
# single-device run
# ---------------------------------------------------------------------------
class SMCResult(NamedTuple):
    particles: MixtureState   # stacked, leading axis P
    log_w: torch.Tensor       # [P] final unnormalized log-weights (float64)
    logz: torch.Tensor        # marginal-likelihood estimate log p(data) (float64)
    n_resamples: int
    # ESS after each absorption step, on the host: one entry per row for
    # run(), one per warmup row then one per block for run_blocked()
    ess_trace: torch.Tensor


# The JAX package fences its row-sequential scan at this many rows (a 50k-row
# scan crashed its TPU worker). Here the scan is O(N) steps with a host read
# each, the wrong algorithm at scale: `run_blocked` (O(N / block) steps) is
# the config-5 path. The cap and its error stay for parity.
ROW_SCAN_CAP = 20_000


def _resample_step(parts, log_w, logz, n_res, generator, ess_threshold, log_p, mesh=None):
    """Resample when ESS < ess_threshold * P (the step's one device read).

    With a particle mesh, log_w and parts are this rank's P / W particles:
    the [P] weights are all-gathered, rank 0 decides and draws the [P]
    parents, and broadcasts [ess, decision, parents] (float64) to the
    others; each rank then takes its parents from the all-gathered stack.
    """
    if mesh is None:
        n_p = log_w.shape[-1]
        ess = profiling.read(torch.exp(log_ess(log_w)), "smc.ess")
        if ess < ess_threshold * n_p:
            idx = systematic_resample(generator, log_w)
            parts = _gather_particles(parts, idx)
            logz = logz + torch.logsumexp(log_w, -1) - log_p
            log_w = torch.zeros_like(log_w)
            n_res += 1
        return parts, log_w, logz, n_res, ess
    log_w_all = mesh_mod.all_gather_cat(log_w, mesh.data_group)
    n_p, p_local = log_w_all.shape[-1], log_w.shape[-1]
    msg = torch.zeros(n_p + 2, dtype=torch.float64, device=log_w.device)
    if mesh.data_index == 0:
        ess = profiling.read(torch.exp(log_ess(log_w_all)), "smc.ess")
        msg[0] = ess
        if ess < ess_threshold * n_p:
            msg[1] = 1.0
            msg[2:] = systematic_resample(generator, log_w_all).to(torch.float64)
    dist.broadcast(msg, src=mesh.rank - mesh.data_index, group=mesh.data_group)
    with profiling.span("read.smc.ess"):
        ess, resample = msg[:2].tolist()
    if resample:
        r0 = mesh.data_index * p_local
        local_idx = msg[2 + r0:2 + r0 + p_local].to(torch.int64)
        parts = map_tensors(lambda t: mesh_mod.all_gather_cat(t, mesh.data_group).index_select(0, local_idx),
                            parts)
        logz = logz + torch.logsumexp(log_w_all, -1) - log_p
        log_w = torch.zeros_like(log_w)
        n_res += 1
    return parts, log_w, logz, n_res, ess


def _final_logz(logz, log_w, log_p, mesh=None):
    """logz plus the log mean weight of all P particles."""
    if mesh is not None:
        log_w = mesh_mod.all_gather_cat(log_w, mesh.data_group)
    return logz + torch.logsumexp(log_w, -1) - log_p


def _start(particles: MixtureState):
    """The run's own copy of the particle tensors, and zero weights (float64)."""
    parts = state_mod.working_copy(particles)
    n_p = parts.counts.shape[0]
    log_w = torch.zeros(n_p, dtype=torch.float64, device=parts.device)
    return parts, log_w, torch.zeros((), dtype=torch.float64, device=parts.device)


def run(
    particles: MixtureState,
    data,
    generator: torch.Generator,
    ess_threshold: float = 0.5,
    rejuvenation_moves: int = 0,
    allow_large: bool = False,
) -> SMCResult:
    """Run SMC over all rows. `particles` from `init_particles` ([P] axis).

    One step a row; each step reads the ESS from the device once to decide
    whether to resample. Refuses more than ROW_SCAN_CAP rows unless
    allow_large.
    """
    return _run(particles, data, generator, ess_threshold, rejuvenation_moves, allow_large)


def _run(particles, data, generator, ess_threshold, rejuvenation_moves, allow_large, mesh=None):
    """`run`'s body; with a particle mesh, this rank's particles of `run_sharded`."""
    n_p = particles.counts.shape[0] * (1 if mesh is None else mesh.data)
    n = particles.assignments.shape[-1]
    if n > ROW_SCAN_CAP and not allow_large:
        raise ValueError(
            f"row-sequential SMC over {n} rows exceeds the safety cap "
            f"({ROW_SCAN_CAP}): it takes one step and one host read a row. "
            "Use run_blocked for at-scale SMC, or pass allow_large=True."
        )
    parts, log_w, logz = _start(particles)
    host = host_generator(generator) if rejuvenation_moves > 0 else None
    log_p = math.log(n_p)
    n_res, ess_trace = 0, []
    for eid in range(n):
        log_w = log_w + _seat_row(parts, data, eid, float(eid), generator).to(log_w.dtype)
        res_before = n_res
        parts, log_w, logz, n_res, ess = _resample_step(
            parts, log_w, logz, n_res, generator, ess_threshold, log_p, mesh)
        ess_trace.append(ess)
        if n_res > res_before and rejuvenation_moves > 0:
            _rejuvenate(parts, data, generator, host, eid, rejuvenation_moves)
    logz = _final_logz(logz, log_w, log_p, mesh)
    return SMCResult(parts, log_w, logz, n_res, torch.tensor(ess_trace, dtype=torch.float64))


def posterior_sample(generator: torch.Generator, result: SMCResult) -> MixtureState:
    """Draw one particle ~ final weights (a posterior partition sample)."""
    i = gumbel_argmax(result.log_w, generator).reshape(1)
    return map_tensors(lambda t: t.index_select(0, i)[0], result.particles)


def posterior_partition_weights(result: SMCResult):
    """(assignments [P, N], normalized weights [P]) for posterior summaries."""
    return result.particles.assignments, torch.softmax(result.log_w, -1)


# ---------------------------------------------------------------------------
# block-SMC: the config-5 at-scale path (O(N / B) steps)
# ---------------------------------------------------------------------------
# Block-SMC absorbs rows in blocks of B via the blocked conditional
# (truncated stick-breaking, the target family of kernels/blocked.py):
#
#   extended target  gamma_b(z_1:bB, w, theta) = p(w) p(theta) prod_i w_zi f(x_i | theta)
#   per block: (1) Gibbs refresh (w, theta) ~ p(. | z_past, x_past), no
#              weight change; (2) propose z_i ~ Cat_k(w_k f_k(x_i))
#              independently over the block; the weight is Rao-Blackwellised
#              over the theta draw (`_absorb_block`).
#
# Resampling is the same systematic scheme; rejuvenation redraws (w, theta)
# and re-assigns `rejuvenation_blocks` random already-seated windows of B
# rows, a partially-collapsed blocked-Gibbs move that leaves the current
# target invariant. Only conjugate likelihoods (additive suffstats).


def _check_block_smc_support(state: MixtureState):
    for lik in state.likelihoods():
        if getattr(lik, "latent_leaves", None) or not lik.conjugate:
            raise ValueError(
                f"block-SMC requires conjugate likelihoods with additive "
                f"suffstats; got {lik.name}"
            )


def _pad_cols(data, n_pad):
    """Columns padded with zero rows (and zero mask) to n_pad rows."""
    out = []
    for x, m in data:
        pad = n_pad - x.shape[0]
        out.append((torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]),
                    torch.cat([m, m.new_zeros(pad)])))
    return tuple(out)


def _draw_log_weights(parts: MixtureState, generator):
    """w ~ p(w | z) under the block family's weight prior (invariant move), [P, K]."""
    if parts.fixed:
        return blocked.dirichlet_log_weights(generator, parts.counts, parts.cluster_hp["alphas"])
    return blocked.stick_break_log_weights(generator, parts.counts, parts.cluster_hp["alpha"])


def _table(parts: MixtureState, thetas, cols):
    """[P, B, K] log f_theta,k(x_i) of every particle's slots, masked rows 0.

    Each feature's `logpdf_batch` scores the P * K slots of the stack at
    once (a cluster axis of P * K), so no [K, B, D] tensor is built.
    """
    n_p, K = parts.counts.shape
    ll = 0.0
    for (x, mask), lik, th in zip(cols, parts.likelihoods(), thetas):
        flat = {k: v.reshape(n_p * K, *v.shape[2:]) for k, v in th.items()}
        t = lik.logpdf_batch(flat, x, mask.to(x.dtype))  # [B, P * K]
        ll = ll + t.reshape(t.shape[0], n_p, K).transpose(0, 1)
    return ll


def _propose_block(parts: MixtureState, cols, generator):
    """Fresh (theta, w) draws and the blocked proposal for every particle:
    (logits [P, B, K], log f [P, B, K], z [P, B] int32)."""
    thetas = [lik.sample_params(generator, h, s)
              for lik, h, s in zip(parts.likelihoods(), state_mod.slot_hypers(parts), parts.stats)]
    logw = _draw_log_weights(parts, generator)
    loglik = _table(parts, thetas, cols)
    logp = logw[:, None, :] + loglik
    return logp, loglik, gumbel_argmax(logp, generator).to(torch.int32)


def _slot_counts(z, valid, K):
    """[P, K] int32 rows of each slot among the valid rows of z [P, B]."""
    vz = torch.where(valid, z.to(torch.int64), K)
    out = torch.zeros((z.shape[0], K + 1), dtype=torch.int32, device=z.device)
    return out.scatter_add_(1, vz, torch.ones_like(vz, dtype=torch.int32))[:, :K]


def _absorb_block(parts: MixtureState, cols, valid, logp, loglik, z):
    """Add the block's rows under z [P, B] to every particle; returns
    (particles, [P] incremental log-weight).

    The weight is Rao-Blackwellised over the theta draw: theta enters the
    proposal only, z_i ~ Cat_k(w_k f_theta,k(x_i)), and the weight targets
    the theta-collapsed extended distribution gamma_b(z, w) = p(w) prod_i
    w_zi prod_k marglik(x's in k), so

        log incr = sum_i logsumexp_k(log w_k + log f_theta,k(x_i))
                 - sum_i log f_theta,z_i(x_i)
                 + sum_k [marglik(stats_k + block) - marglik(stats_k)]

    (the w_z prior factor cancels against the proposal's numerator), and
    E_q[exp(incr)] = p(x_block | z_past, w, x_past) for any theta draw.
    """
    loglik_z = loglik.gather(-1, z.to(torch.int64)[..., None])[..., 0]
    incr = torch.where(valid, torch.logsumexp(logp, -1) - loglik_z, 0.0).sum(-1)
    counts = parts.counts + _slot_counts(z, valid, parts.k_max)
    new_stats = []
    for lik, h, s_f, s_b in zip(parts.likelihoods(), state_mod.slot_hypers(parts), parts.stats,
                                blocked.block_stats(parts, cols, z, valid)):
        s_new = {k: s_f[k] + s_b[k] for k in s_f}
        ml_new = lik.marginal_loglik(h, s_new)  # [P, K]
        ml_old = lik.marginal_loglik(h, s_f)
        incr = incr + (torch.where(s_new["n"] > 0, ml_new, 0.0)
                       - torch.where(s_f["n"] > 0, ml_old, 0.0)).sum(-1)
        new_stats.append(s_new)
    return dataclasses.replace(parts, counts=counts, stats=tuple(new_stats)), incr


def _seat_block(parts: MixtureState, cols, valid, generator):
    """Seat one block in every particle: returns (particles, z [P, B], [P] log-weight).

    One suffstat rebuild (`blocked.block_stats`): for an niw feature on the
    card, one launch of the scatter kernel.
    """
    logp, loglik, z = _propose_block(parts, cols, generator)
    parts, incr = _absorb_block(parts, cols, valid, logp, loglik, z)
    return parts, z, incr


def _warmup_row(parts: MixtureState, data, eid: int, generator):
    """Seat ONE row under the theta-collapsed extended target gamma(z, w), in
    place; returns the [P] incremental log-weight.

    Per row: refresh w ~ p(w | z_past) (an invariant Gibbs move: theta is
    collapsed, so w is independent of x given z), then propose z from the
    optimal collapsed proposal q(k) prop. to w_k pred_k(x_row). The weight
    for gamma prop. to p(w) prod_i w_zi prod_k marglik_k is then exactly
    logsumexp_k(log w_k + log pred_k(x_row)), independent of the drawn z.
    """
    logp = _draw_log_weights(parts, generator) + state_mod.pred_scores(parts, data, eid)
    state_mod.add_value_(parts, data, eid, gumbel_argmax(logp, generator))
    return torch.logsumexp(logp, -1)


def _rejuv_block(parts: MixtureState, cols, z_old, valid, generator):
    """Re-assign one already-seated block given fresh (w, theta) draws:
    returns (particles, z_new [P, B]). Two suffstat rebuilds (the new and
    the old assignment): for an niw feature on the card, two launches of the
    scatter kernel."""
    _, _, z_new = _propose_block(parts, cols, generator)
    K = parts.k_max
    counts = parts.counts + _slot_counts(z_new, valid, K) - _slot_counts(z_old, valid, K)
    s_new = blocked.block_stats(parts, cols, z_new, valid)
    s_old = blocked.block_stats(parts, cols, z_old, valid)
    stats = tuple({k: s_f[k] + a[k] - b[k] for k in s_f}
                  for s_f, a, b in zip(parts.stats, s_new, s_old))
    return dataclasses.replace(parts, counts=counts, stats=stats), z_new


def run_blocked(
    particles: MixtureState,
    data,
    generator: torch.Generator,
    block: int = 4096,
    ess_threshold: float = 0.5,
    rejuvenation_blocks: int = 1,
    warmup: int = 512,
) -> SMCResult:
    """Block-SMC over all rows (config 5): warmup rows, then O(N / block) steps.

    `particles` from `init_particles` ([P] leading axis). The evidence
    estimate targets the truncated stick-breaking model (the blocked-Gibbs
    family's target).

    * Incremental weights are Rao-Blackwellised over the per-block theta
      draw (`_absorb_block`).
    * The first min(warmup, n) rows are seated row-sequentially under the
      same theta-collapsed extended target (`_warmup_row`): a one-shot
      importance weight for a whole block proposed from a prior-theta draw
      on a near-empty state has O(block) variance.
    * Rejuvenation runs every block step (and every `block` warmup rows),
      decoupled from resampling.

    rejuvenation_blocks: how many random already-seated `block`-row windows
    get a blocked-Gibbs re-assignment a step. The log-Z estimate is
    unbiased at any setting (including 0).

    Each warmup row and each block reads the ESS from the device once. For
    an niw feature on the card the suffstat rebuilds run through the
    scatter kernel: per block step 1 + 2 * rejuvenation_blocks launches
    (the seat, then each window's new and old assignment), plus
    2 * rejuvenation_blocks for every `block` warmup rows when
    warmup > block.

    The returned SMCResult.ess_trace has one entry per warmup row followed
    by one per block (length min(warmup, n) + ceil((n - W) / block)).
    """
    return _run_blocked(particles, data, generator, block, ess_threshold, rejuvenation_blocks, warmup)


def _run_blocked(particles, data, generator, block, ess_threshold, rejuvenation_blocks, warmup,
                 mesh=None):
    """`run_blocked`'s body; with a particle mesh, this rank's particles of
    `run_blocked_sharded`."""
    with profiling.span("smc.pass"):
        _check_block_smc_support(particles)
        n_p = particles.counts.shape[0]
        n = particles.assignments.shape[-1]
        w_rows = min(warmup, n)
        nb = max(0, -(-(n - w_rows) // block))
        n_pad = w_rows + nb * block
        data_p = _pad_cols(data, n_pad)
        parts, log_w, logz = _start(particles)
        pad = torch.full((n_p, n_pad - n), -1, dtype=parts.assignments.dtype, device=parts.device)
        parts = dataclasses.replace(parts, assignments=torch.cat([parts.assignments, pad], 1))
        host = host_generator(generator)
        log_p = math.log(n_p * (1 if mesh is None else mesh.data))
        n_res, ess_trace = 0, []

        def window(off):
            cols = tuple((x[off:off + block], m[off:off + block]) for x, m in data_p)
            return cols, torch.arange(off, off + block, device=parts.device) < n

        def rejuvenate(parts, seated):
            """Blocked-Gibbs re-assignment of random seated windows [roff, roff + block)."""
            with profiling.span("smc.rejuv"):
                for _ in range(rejuvenation_blocks):
                    roff = int(torch.randint(0, max(seated - block + 1, 1), (1,), generator=host))
                    rcols, rvalid = window(roff)
                    parts, z_new = _rejuv_block(parts, rcols, parts.assignments[:, roff:roff + block],
                                                rvalid, generator)
                    parts.assignments[:, roff:roff + block] = z_new
            return parts

        for eid in range(w_rows):
            with profiling.span("smc.warmup_step"):
                with profiling.span("smc.seat"):
                    log_w = log_w + _warmup_row(parts, data_p, eid, generator).to(log_w.dtype)
                with profiling.span("smc.resample"):
                    parts, log_w, logz, n_res, ess = _resample_step(
                        parts, log_w, logz, n_res, generator, ess_threshold, log_p, mesh)
                ess_trace.append(ess)
                if rejuvenation_blocks > 0 and w_rows > block and (eid + 1) % block == 0:
                    parts = rejuvenate(parts, eid + 1)

        for b in range(nb):
            with profiling.span("smc.block_step"):
                off = w_rows + b * block
                cols, valid = window(off)
                with profiling.span("smc.seat"):
                    parts, z_blk, incr = _seat_block(parts, cols, valid, generator)
                    parts.assignments[:, off:off + block] = z_blk
                    log_w = log_w + incr.to(log_w.dtype)
                with profiling.span("smc.resample"):
                    parts, log_w, logz, n_res, ess = _resample_step(
                        parts, log_w, logz, n_res, generator, ess_threshold, log_p, mesh)
                ess_trace.append(ess)
                if rejuvenation_blocks > 0:
                    parts = rejuvenate(parts, off + block)

        logz = _final_logz(logz, log_w, log_p, mesh)
        parts = dataclasses.replace(parts, assignments=parts.assignments[:, :n].contiguous())
        return SMCResult(parts, log_w, logz, n_res, torch.tensor(ess_trace, dtype=torch.float64))


# ---------------------------------------------------------------------------
# particles sharded over the processes of a torch.distributed job
# ---------------------------------------------------------------------------
def make_particle_mesh(backend: str, device=None) -> "mesh_mod.Mesh":
    """A (1 x W) mesh over the W processes of the default group: the
    particle axis rides the mesh's data axis (`parallel.make_mesh`)."""
    mesh_mod.init_distributed(backend)
    return mesh_mod.make_mesh(1, dist.get_world_size(), backend=backend, device=device)


def shard_particles(mesh, particles: MixtureState, data):
    """This rank's P / W particles of a [P] stack, and the data (replicated),
    on the mesh's device. P must divide over the W ranks."""
    if mesh.chains != 1:
        raise ValueError(f"particles shard over a (1 x W) mesh, got {mesh.shape}")
    p0, p1 = mesh_mod.row_span(mesh, particles.counts.shape[0])
    local = map_tensors(lambda t: t[p0:p1].to(mesh.device), particles)
    cols = tuple((x.to(mesh.device), m.to(mesh.device)) for x, m in data)
    return local, cols


def _rank_generator(mesh, generator: torch.Generator) -> torch.Generator:
    """Rank 0: the caller's generator. Rank r > 0: a generator seeded from one
    draw of the caller's and r, so equally seeded callers still draw apart."""
    if mesh.data_index == 0:
        return generator
    draw = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    seed = int(np.random.SeedSequence([draw, mesh.data_index]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=generator.device).manual_seed(seed)


def run_sharded(mesh, particles: MixtureState, data, generator: torch.Generator,
                ess_threshold: float = 0.5, rejuvenation_moves: int = 0,
                allow_large: bool = False) -> SMCResult:
    """`run` with the particle axis sharded over `mesh` (collective resampling).

    particles and data from `shard_particles`. Returns this rank's
    particles and log-weights, and the global logz (equal on every rank).
    One all_gather of the [P] log-weights and one broadcast a row; an
    all_gather of the particle state at each resample.
    """
    return _run(particles, data, _rank_generator(mesh, generator), ess_threshold, rejuvenation_moves,
                allow_large, mesh)


def run_blocked_sharded(mesh, particles: MixtureState, data, generator: torch.Generator,
                        block: int = 4096, ess_threshold: float = 0.5,
                        rejuvenation_blocks: int = 1, warmup: int = 512) -> SMCResult:
    """`run_blocked` with the particle axis sharded over `mesh`.

    particles and data from `shard_particles`; each rank runs `run_blocked`'s
    steps on its P / W particles (kernel 2 on its NIW rebuilds on the card)
    and its own rejuvenation windows. Resampling as `run_sharded`. Returns
    this rank's particles and log-weights and the global logz.
    """
    return _run_blocked(particles, data, _rank_generator(mesh, generator), block, ess_threshold,
                        rejuvenation_blocks, warmup, mesh)
