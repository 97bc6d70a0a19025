"""Blocked (uncollapsed) Gibbs (port of `common_tpu/kernels/blocked.py`).

A truncated stick-breaking DP mixture (Ishwaran & James blocked Gibbs) in
which every row is resampled in parallel:

  1. theta_k ~ p(theta | stats_k)   posterior draws for all K slots at once
                                   (empty slots draw from the prior);
  2. stick weights                 v_k ~ Beta(1 + n_k, alpha + sum_{j>k} n_j),
                                   log w = log v + cumsum log(1 - v);
                                   fixed-K: w ~ Dirichlet(alpha + n);
  3. score + assign                Gumbel-argmax over the [N, K] log table;
  4. restat                        counts + suffstats rebuilt from z.

`sweep` runs steps 3-4 in plain tensor ops. `sweep_fused` runs step 3
through the hand-written assignment kernel (the [N, K] table never reaches
device memory) and the scatter matrices of step 4 through the suffstat
kernel (`ops/`). Both take an explicit `torch.Generator` on the state's
device and consume it in order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from common_tpu_torch import state as state_mod
from common_tpu_torch.ops.gaussian_assign import fused_gaussian_assign
from common_tpu_torch.ops.suffstat import fused_scatter_stats
from common_tpu_torch.rng import beta, gumbel_argmax, standard_gamma
from common_tpu_torch.state import MixtureState


def _require_fp32() -> None:
    """Refuse to sample with TF32 matmuls: reduced precision biases the sampler."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True; the blocked sweep "
            "needs fp32 products (common_tpu/likelihoods/niw.py, sample_params_prec)"
        )


def stick_break_log_weights(generator, counts, alpha):
    """log mixture weights from a truncated stick-breaking posterior draw.

    v_k ~ Beta(1 + n_k, alpha + sum_{j>k} n_j), clipped to [1e-7, 1 - 1e-7];
    the last stick takes the rest (so sum w = 1 under truncation).
    """
    c = counts.to(alpha.dtype)
    total_after = c.flip(-1).cumsum(-1).flip(-1) - c  # sum_{j>k} n_j
    v = beta(1.0 + c, alpha + total_after, generator).clamp(1e-7, 1.0 - 1e-7)
    log1mv = torch.log1p(-v)
    cum = torch.cat([torch.zeros_like(log1mv[:1]), torch.cumsum(log1mv[:-1], 0)])
    logw = torch.log(v) + cum
    # final stick absorbs the remainder: w_K = prod_{j<K} (1 - v_j)
    return torch.cat([logw[:-1], log1mv[:-1].sum().reshape(1)])


def dirichlet_log_weights(generator, counts, alphas):
    """Fixed-K: log w with w ~ Dirichlet(alpha + n) (blocked finite mixture)."""
    g = standard_gamma(alphas + counts.to(alphas.dtype), generator)
    return torch.log(torch.clamp(g / g.sum(), min=1e-30))


def _log_weights(state: MixtureState, generator):
    if state.fixed:
        return dirichlet_log_weights(generator, state.counts, state.cluster_hp["alphas"])
    return stick_break_log_weights(generator, state.counts, state.cluster_hp["alpha"])


def sweep_parts(state: MixtureState, data, generator):
    """The (theta, log w, [N, K] log-lik table) pieces of one blocked sweep."""
    liks = state.likelihoods()
    thetas = [
        lik.sample_params(generator, hyper, stats_f)
        for lik, hyper, stats_f in zip(liks, state.hypers, state.stats)
    ]
    logw = _log_weights(state, generator)

    def loglik_table(data_cols):
        ll = 0.0
        for (x, mask), lik, th in zip(data_cols, liks, thetas):
            ll = ll + lik.logpdf_batch(th, x, mask.to(x.dtype))
        return ll

    return thetas, logw, loglik_table


def sweep(state: MixtureState, data, generator) -> MixtureState:
    """One full blocked-Gibbs sweep in plain tensor ops: all rows reassigned."""
    _require_fp32()
    thetas, logw, loglik_table = sweep_parts(state, data, generator)
    logp = logw[None, :] + loglik_table(data)  # [N, K]; masked rows score 0
    z = gumbel_argmax(logp, generator).to(torch.int32)
    return restat(state, data, z, thetas)


def restat(state: MixtureState, data, z, thetas=None) -> MixtureState:
    """Rebuild counts + suffstats from a full assignment vector.

    thetas: optional per-feature parameter draws to persist into latent
    stat leaves (none for niw).
    """
    K = state.k_max
    new_stats = []
    for f, ((x, mask), lik, hyper) in enumerate(
        zip(data, state.likelihoods(), state.hypers)
    ):
        s = lik.stats_from_assignments(hyper, x, mask, z, K)
        if thetas is not None and lik.latent_leaves:
            s = {k: (thetas[f][k] if k in lik.latent_leaves else s[k]) for k in s}
        new_stats.append(s)
    return dataclasses.replace(
        state, assignments=z, counts=state_mod._assignment_counts(z, K),
        stats=tuple(new_stats),
    )


def assign(state: MixtureState, data, generator) -> MixtureState:
    """Runner-kernel alias ('assign_blocked')."""
    return sweep(state, data, generator)


# ---------------------------------------------------------------------------
# fused path (single niw feature)
# ---------------------------------------------------------------------------
def fused_assign_inputs(state: MixtureState, data, generator):
    """(mu [K, D], binv [K, D, D], base [K], log w [K]) for the assignment kernel.

    binv = L_k^{-1} (lower triangular) with L_k the Cholesky factor of the
    drawn Sigma_k; base = log w_k - 1/2 log|Sigma_k| - D/2 log 2 pi.
    """
    if state.lik_names == ("bbv",):
        raise ValueError(
            "sweep_fused: bbv needs the linear-score assignment kernel "
            "(common_tpu/ops/linear_assign.py), which is not ported yet"
        )
    if state.lik_names != ("niw",):
        raise ValueError(
            f"sweep_fused supports a single niw feature, got {state.lik_names}"
        )
    x = data[0][0]
    d = x.shape[-1]
    lik = state.likelihoods()[0]
    theta = lik.sample_params(generator, state.hypers[0], state.stats[0])
    mu, chol = theta["mu"], theta["cov_chol"]
    eye = torch.eye(d, dtype=chol.dtype, device=chol.device).expand_as(chol)
    binv = torch.linalg.solve_triangular(chol, eye, upper=False)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    logw = _log_weights(state, generator)
    base = logw - 0.5 * logdet - 0.5 * d * math.log(2.0 * math.pi)
    return mu.contiguous(), binv.contiguous(), base.contiguous(), logw


def sweep_fused(state: MixtureState, data, generator) -> MixtureState:
    """Blocked sweep through the hand-written kernels (single niw feature).

    Same sampler as `sweep`. The assignment kernel scores, adds Gumbel
    noise and takes the argmax without writing the [N, K] table; the
    suffstat kernel rebuilds sum_xxT in N*D^2 multiply-adds. counts, n and
    sum_x stay plain tensor ops. Fixed-K (Dirichlet) and DP (stick-breaking)
    weights both work. On CPU tensors the kernels' plain versions run.
    """
    _require_fp32()
    mu, binv, base, logw = fused_assign_inputs(state, data, generator)
    x, mask = data[0]
    n, K = x.shape[0], state.k_max
    seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=x.device, dtype=torch.int32)
    z = fused_gaussian_assign(x, mu, binv, base, seed)
    # fully-masked rows carry no likelihood: assign from the weights alone
    z_prior = gumbel_argmax(logw.expand(n, K), generator).to(torch.int32)
    m = mask.to(x.dtype)
    z = torch.where(m > 0, z, z_prior)

    zi = torch.where(m > 0, z, K)  # masked rows: counted, not accumulated
    onehot = (zi[:, None] == torch.arange(K, device=x.device)).to(x.dtype)
    stats = {
        "n": onehot.sum(0),
        "sum_x": onehot.T @ x,
        "sum_xxT": fused_scatter_stats(x, zi, K),
    }
    return dataclasses.replace(
        state, assignments=z, counts=state_mod._assignment_counts(z, K),
        stats=(stats,),
    )
