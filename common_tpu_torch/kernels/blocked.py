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
through a hand-written assignment kernel (the [N, K] table never reaches
device memory): the Gaussian one for a single niw feature, with the
scatter matrices of step 4 through the suffstat kernel, or the linear one
for a single bbv feature (`ops/`). `sweep_chains` sweeps C chains that
share one dataset, through wide products or the multi-chain assignment
kernel. All take an explicit `torch.Generator` on the state's device and
consume it in order.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from common_tpu_torch import state as state_mod
from common_tpu_torch.ops.gaussian_assign import (
    fused_gaussian_assign,
    fused_gaussian_assign_chains,
)
from common_tpu_torch.ops.linear_assign import fused_linear_assign
from common_tpu_torch.ops.suffstat import fused_scatter_stats
from common_tpu_torch.parallel.chains import vmap_sweep
from common_tpu_torch.rng import beta, device_seed, gumbel, gumbel_argmax, standard_gamma
from common_tpu_torch.state import MixtureState
from common_tpu_torch.utils import profiling


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
    Batched over leading axes of `counts` (a [P, K] particle stack with
    alpha [P]); one state's [K] counts and 0-d alpha draw as before.
    """
    c = counts.to(alpha.dtype)
    total_after = c.flip(-1).cumsum(-1).flip(-1) - c  # sum_{j>k} n_j
    v = beta(1.0 + c, alpha[..., None] + total_after, generator).clamp(1e-7, 1.0 - 1e-7)
    log1mv = torch.log1p(-v)
    cum = torch.cat([torch.zeros_like(log1mv[..., :1]), torch.cumsum(log1mv[..., :-1], -1)], -1)
    logw = torch.log(v) + cum
    # final stick absorbs the remainder: w_K = prod_{j<K} (1 - v_j)
    return torch.cat([logw[..., :-1], log1mv[..., :-1].sum(-1, keepdim=True)], -1)


def dirichlet_log_weights(generator, counts, alphas):
    """Fixed-K: log w with w ~ Dirichlet(alpha + n) (blocked finite mixture),
    batched over leading axes as `stick_break_log_weights`."""
    g = standard_gamma(alphas + counts.to(alphas.dtype), generator)
    return torch.log(torch.clamp(g / g.sum(-1, keepdim=True), min=1e-30))


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
# fused path (single niw or bbv feature)
# ---------------------------------------------------------------------------
def fused_assign_inputs(state: MixtureState, data, generator):
    """(mu [K, D], binv [K, D, D], base [K], log w [K]) for the assignment kernel.

    binv = L_k^{-1} (lower triangular) with L_k the Cholesky factor of the
    drawn Sigma_k; base = log w_k - 1/2 log|Sigma_k| - D/2 log 2 pi.
    """
    if state.lik_names != ("niw",):
        raise ValueError(f"fused_assign_inputs needs a single niw feature, got {state.lik_names}")
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


def linear_assign_inputs(state: MixtureState, data, generator):
    """(W [K, D], base [K], log w [K]) for the linear assignment kernel (bbv).

    log p(x | p_k) = x . (log p_k - log(1 - p_k)) + sum_d log(1 - p_kd), so
    W = logit p and base = log w + sum_d log1p(-p).
    """
    lik = state.likelihoods()[0]
    p = lik.sample_params(generator, state.hypers[0], state.stats[0])["p"]
    lp, lq = torch.log(p), torch.log1p(-p)
    logw = _log_weights(state, generator)
    base = logw + lq.sum(-1)
    return (lp - lq).contiguous(), base.contiguous(), logw


def _prior_fallback(z, logw, mask, generator):
    """Fully-masked rows carry no likelihood: assign them from the weights alone."""
    n, K = z.shape[0], logw.shape[-1]
    z_prior = gumbel_argmax(logw.expand(n, K), generator).to(torch.int32)
    return torch.where(mask > 0, z, z_prior)


def _onehot(z, m, K):
    """[..., N, K] one-hot of z [..., N]; masked rows (m == 0) are counted nowhere."""
    zi = torch.where(m > 0, z, K)
    return zi, (zi[..., None] == torch.arange(K, device=z.device)).to(m.dtype)


def _fused_niw_stats(x, m, z, K):
    """niw suffstats of one assignment z [N], or of P at once (z [P, N], leaves
    [P, K, ...]): n and sum_x by one-hot, sum_xxT by the kernel in one launch.

    For P assignments the kernel sees the rows repeated P times and the
    P * K slots side by side (slot k of assignment p is cluster p * K + k).
    """
    zi, onehot = _onehot(z, m, K)
    stats = {"n": onehot.sum(-2), "sum_x": onehot.transpose(-1, -2) @ x}
    if z.dim() == 1:
        return {**stats, "sum_xxT": fused_scatter_stats(x, zi, K)}
    P = z.shape[0]
    offset = torch.arange(P, device=z.device)[:, None] * K
    flat = torch.where((zi >= 0) & (zi < K), zi + offset, P * K).reshape(-1).to(torch.int32)
    sum_xxT = fused_scatter_stats(x.repeat(P, 1), flat, P * K)
    return {**stats, "sum_xxT": sum_xxT.reshape(P, K, *sum_xxT.shape[1:])}


def block_stats(state: MixtureState, data_cols, z, valid, K=None):
    """Per-feature suffstats of the rows `data_cols` under assignment z.

    Rows with `valid` False, a zero mask or z outside [0, K) add nothing. K
    defaults to the state's k_max (split-merge asks for 2). One state's z
    [B] gives leaves [K, ...]; a particle stack's z [P, B] gives [P, K, ...].
    The suffstat rebuild of block-SMC and split-merge:

    - an niw feature on the card: n and sum_x by one-hot, sum_xxT by the
      scatter kernel (`ops/suffstat.py`), one launch for all P assignments;
    - on the CPU, or any other likelihood: `stats_from_assignments` over
      the rows repeated P times, the P * K slots side by side.

    The hypers set only the dtype and the leaves' shapes here, so a
    stack's first particle's serve for all.
    """
    K = state.k_max if K is None else K
    stacked = state.counts.dim() == 2
    P = z.shape[0] if stacked else 1
    zz = z if stacked else z[None]
    out = []
    for (x, mask), lik, hyper in zip(data_cols, state.likelihoods(), state.hypers):
        if lik.name == "niw" and x.device.type != "cpu":
            m = mask.to(x.dtype) * valid.to(x.dtype)
            out.append(_fused_niw_stats(x, m, z.to(torch.int32), K))
            continue
        keep = valid & (zz >= 0) & (zz < K)
        if not stacked:
            out.append(lik.stats_from_assignments(hyper, x, mask, torch.where(keep[0], z, K), K))
            continue
        offset = torch.arange(P, device=z.device)[:, None] * K
        gid = torch.where(keep, zz.to(torch.int64) + offset, P * K).reshape(-1)
        reps = (P,) + (1,) * (x.dim() - 1)
        s = lik.stats_from_assignments({k: v[0] for k, v in hyper.items()}, x.repeat(reps),
                                       mask.repeat(P), gid, P * K)
        out.append({k: v.reshape(P, K, *v.shape[1:]) for k, v in s.items()})
    return tuple(out)


def sweep_fused(state: MixtureState, data, generator, fused_restat: bool = True) -> MixtureState:
    """Blocked sweep through the hand-written kernels (single niw or bbv feature).

    Same sampler as `sweep`. The assignment kernel scores, adds Gumbel
    noise and takes the argmax without writing the [N, K] table. For niw
    the suffstat kernel rebuilds sum_xxT in N*D^2 multiply-adds; counts, n
    and sum_x stay plain tensor ops. bbv goes to `_sweep_fused_bbv`.
    Fixed-K (Dirichlet) and DP (stick-breaking) weights both work. On CPU
    tensors the kernels' plain versions run. fused_restat=False rebuilds
    the niw stats through `restat` (plain tensor ops) instead of the
    suffstat kernel, as in the JAX package; the bbv restat is one product
    either way. Its phases are the spans `sweep.inputs` (theta and the
    weights), `sweep.assign` and `sweep.restat`.
    """
    _require_fp32()
    if state.lik_names == ("bbv",):
        return _sweep_fused_bbv(state, data, generator)
    if state.lik_names != ("niw",):
        raise ValueError(f"sweep_fused supports a single niw or bbv feature, got {state.lik_names}")
    with profiling.span("sweep.inputs"):
        mu, binv, base, logw = fused_assign_inputs(state, data, generator)
    x, mask = data[0]
    K = state.k_max
    m = mask.to(x.dtype)
    with profiling.span("sweep.assign"):
        z = fused_gaussian_assign(x, mu, binv, base, device_seed(generator, x.device))
        z = _prior_fallback(z, logw, m, generator)
    with profiling.span("sweep.restat"):
        if not fused_restat:
            return restat(state, data, z)
        return dataclasses.replace(
            state, assignments=z, counts=state_mod._assignment_counts(z, K),
            stats=(_fused_niw_stats(x, m, z, K),),
        )


def _sweep_fused_bbv(state: MixtureState, data, generator) -> MixtureState:
    """bbv: the linear assignment kernel, then n and heads by one product.

    The score is affine in the row, so the kernel is `ops/linear_assign.py`;
    the restat needs no scatter-matrix kernel.
    """
    with profiling.span("sweep.inputs"):
        W, base, logw = linear_assign_inputs(state, data, generator)
    x, mask = data[0]
    xf = x.to(torch.float32).contiguous()
    K = state.k_max
    m = mask.to(torch.float32)
    with profiling.span("sweep.assign"):
        z = fused_linear_assign(xf, W, base, device_seed(generator, x.device))
        z = _prior_fallback(z, logw, m, generator)
    with profiling.span("sweep.restat"):
        _, onehot = _onehot(z, m, K)
        stats = {"n": onehot.sum(0), "heads": onehot.T @ xf}
        return dataclasses.replace(
            state, assignments=z, counts=state_mod._assignment_counts(z, K),
            stats=(stats,),
        )


# ---------------------------------------------------------------------------
# multi-chain sweep: C chains sharing one dataset
# ---------------------------------------------------------------------------
def _chain_score_table(mu, prec, logdet, logw, x):
    """[N, C, K] blocked-Gibbs score table for C chains sharing X.

    The Gaussian quadratic form is expanded,
        -1/2 (x - mu)^T P (x - mu) = -1/2 x^T P x + x^T P mu - 1/2 mu^T P mu,
    with P = Sigma^-1, so all C*K clusters are scored by two wide products
    against shared row features: XX @ P^T with XX the [N, D^2] outer
    products, and X @ Q^T. fp32 products (TF32 is refused): the expansion
    cancels (x^T P x ~ mu^T P mu for tight clusters).

    mu [C, K, D], prec [C, K, D, D], logdet [C, K] (log|Sigma|), logw [C, K].
    """
    C, K, D = mu.shape
    P = prec.reshape(C * K, D, D)
    m = mu.reshape(C * K, D)
    q = (P @ m[..., None])[..., 0]  # Sigma^-1 mu [CK, D]
    r = (q * m).sum(-1)  # mu^T Sigma^-1 mu [CK]
    base = (
        logw.reshape(C * K)
        - 0.5 * logdet.reshape(C * K)
        - 0.5 * D * math.log(2.0 * math.pi)
        - 0.5 * r
    )
    xx = (x[:, :, None] * x[:, None, :]).reshape(-1, D * D)
    quad = xx @ P.reshape(C * K, D * D).T  # [N, CK]
    lin = x @ q.T  # [N, CK]
    logp = base[None, :] - 0.5 * quad + lin
    return logp.reshape(-1, C, K)


def _chain_parts(states: MixtureState, generator):
    """(theta, log w [C, K]) of one multi-chain sweep.

    theta = `sample_params_prec` for all C*K slots in one batched call (the
    hypers get a slot axis, [C, 1, ...], to broadcast against the stats'
    [C, K, ...]); the weights per chain, since the stick-breaking and
    Dirichlet draws are 1-D.
    """
    lik = states.likelihoods()[0]
    hyper = {k: v.unsqueeze(1) for k, v in states.hypers[0].items()}
    theta = lik.sample_params_prec(generator, hyper, states.stats[0])
    n_chains = states.counts.shape[0]
    if states.fixed:
        logw = [dirichlet_log_weights(generator, states.counts[c], states.cluster_hp["alphas"][c])
                for c in range(n_chains)]
    else:
        logw = [stick_break_log_weights(generator, states.counts[c], states.cluster_hp["alpha"][c])
                for c in range(n_chains)]
    return theta, torch.stack(logw)


def chain_assign_inputs(states: MixtureState, data, generator):
    """(mu [C*K, D], minv [C*K, D, D], base [C*K], log w [C, K]) for the
    multi-chain assignment kernel.

    minv = A^T L^-1, the precision square root of the Bartlett draw
    (dense, not triangular): ||minv (x - mu)||^2 is the Mahalanobis form.
    base = log w - 1/2 log|Sigma| - D/2 log 2 pi, chain-major.
    """
    theta, logw = _chain_parts(states, generator)
    C, K, D = theta["mu"].shape
    base = logw - 0.5 * theta["logdet"] - 0.5 * D * math.log(2.0 * math.pi)
    return (theta["mu"].reshape(C * K, D).contiguous(),
            theta["minv"].reshape(C * K, D, D).contiguous(),
            base.reshape(C * K).contiguous(), logw)


_FALLBACK_WARNED = False


def sweep_chains(states: MixtureState, data, generator, d_max_xx: int = 64,
                 fused: bool = False, assume_dense_mask: bool = False,
                 xx_budget_bytes: float = 2e9) -> MixtureState:
    """One blocked sweep of C chain-stacked states sharing one dataset.

    `states` carries a leading chain axis on every tensor
    (`parallel.stack_states`); `data` the shared ((x, mask),) columns.
    Per chain the same sampler as `sweep`. Three routes, gated as in the
    JAX package:

    - wide (a single niw feature, D <= d_max_xx and the [N, D^2] outer
      products within xx_budget_bytes): all C*K clusters scored by two
      wide products (`_chain_score_table`), Gumbel-argmax per chain;
    - fused (fused=True, a single niw feature, any D): the multi-chain
      assignment kernel, which reads X once for all chains; its masked
      rows are drawn from the weights alone unless assume_dense_mask;
    - otherwise a per-chain loop of `sweep`, with a one-time warning.

    The restat takes two wide products for all chains when the [N, D^2]
    features are within budget, and otherwise, per chain, n and sum_x by
    one-hot and sum_xxT by the suffstat kernel (the restat of
    `sweep_fused`). On the wide and fused routes the phases are the spans
    `sweep.inputs`, `sweep.assign` and `sweep.restat`, as in `sweep_fused`.
    """
    global _FALLBACK_WARNED
    _require_fp32()
    if states.lik_names == ("niw",):
        n_rows, d = data[0][0].shape[-2], data[0][0].shape[-1]
        xx_bytes = 4.0 * n_rows * d * d
        wide_ok = fused or (d <= d_max_xx and xx_bytes <= xx_budget_bytes)
    else:
        d, xx_bytes, wide_ok = None, 0.0, False
    if not wide_ok:
        if not _FALLBACK_WARNED:
            warnings.warn(
                f"sweep_chains: falling back to per-chain sweeps "
                f"(lik={states.lik_names}, D={d}, [N,D^2] "
                f"{xx_bytes / 1e9:.1f} GB vs budget "
                f"{xx_budget_bytes / 1e9:.1f} GB); `fused` and "
                f"`assume_dense_mask` are ignored on this path. Pass "
                f"fused=True for the multi-chain assignment kernel (no D limit).",
                stacklevel=2,
            )
            _FALLBACK_WARNED = True
        return vmap_sweep(sweep)(states, data, generator)

    x, mask = data[0]
    N, D = x.shape
    C, K = states.counts.shape
    m = mask.to(x.dtype)
    if fused:
        with profiling.span("sweep.inputs"):
            mu, minv, base, logw = chain_assign_inputs(states, data, generator)
        with profiling.span("sweep.assign"):
            z = fused_gaussian_assign_chains(x, mu, minv, base, device_seed(generator, x.device), C).T
            if not assume_dense_mask:
                g = gumbel((N, C, K), generator, logw.dtype)
                z_prior = torch.argmax(logw[None] + g, dim=-1).to(torch.int32)
                z = torch.where(m[:, None] > 0, z, z_prior)
    else:
        with profiling.span("sweep.inputs"):
            theta, logw = _chain_parts(states, generator)
        with profiling.span("sweep.assign"):
            logp = _chain_score_table(theta["mu"], theta["prec"], theta["logdet"], logw, x)
            g = gumbel((N, C, K), generator, logp.dtype)
            z = torch.argmax(logp + g, dim=-1).to(torch.int32)  # [N, C]
            # fully-masked rows: assign from the weights alone
            z_prior = torch.argmax(logw[None] + g, dim=-1).to(torch.int32)
            z = torch.where(m[:, None] > 0, z, z_prior)
    with profiling.span("sweep.restat"):
        if xx_bytes <= xx_budget_bytes:
            # restat: all C chains in two wide products against shared (X, XX)
            onehot = (z[:, :, None] == torch.arange(K, device=x.device)).to(x.dtype)  # [N, C, K]
            counts = onehot.sum(0).to(torch.int32)
            w = (onehot * m[:, None, None]).reshape(N, C * K)
            xx = (x[:, :, None] * x[:, None, :]).reshape(N, D * D)
            sum_xxT = (w.T @ xx).reshape(C, K, D, D)
            stats = {
                "n": w.sum(0).reshape(C, K),
                "sum_x": (w.T @ x).reshape(C, K, D),
                "sum_xxT": 0.5 * (sum_xxT + sum_xxT.transpose(-1, -2)),
            }
        else:
            # [N, D^2] over budget (the fused route at 1M x 256): per chain
            per_chain = [_fused_niw_stats(x, m, z[:, c].contiguous(), K) for c in range(C)]
            stats = {leaf: torch.stack([s[leaf] for s in per_chain]) for leaf in per_chain[0]}
            counts = torch.stack([state_mod._assignment_counts(z[:, c], K) for c in range(C)])
        return dataclasses.replace(
            states, assignments=z.T.contiguous(), counts=counts, stats=(stats,),
        )
