"""Stochastic variational inference for DP mixtures (port of `common_tpu/kernels/svi.py`).

Mean-field family (Blei & Jordan 2006 truncation; Hoffman et al. 2013
natural-gradient updates):

  q(v_k)     = Beta(a_k, b_k), k < K-1; v_{K-1} = 1   (stick truncation)
  q(theta_k) = the conjugate family at posterior_hyper(prior, vstats_k):
               the variational state is a pseudo-suffstat dict, so a
               natural-gradient step is a convex blend of suffstats,
                 vstats <- (1 - rho) vstats + rho (N / B) sum_batch r_nk t(x_n)
  q(z_n)     = Categorical(r_n)  (local; recomputed each E-step)

Every expectation comes from the likelihoods' exponential-family structure
(`likelihoods/expfam.py`): nothing here is model-specific. The E-step is
one [N, K] table a feature, built by one product; the M-step is each
likelihood's `stats_from_weights`. Full batch with rho = 1 is exact CAVI,
whose ELBO (`elbo`) never falls.

The JAX package runs the fit loops as `lax.scan`s. Here they are Python
loops whose traces (the ELBO, the step sizes) stay on the device until the
loop ends; nothing in a step waits for the device. Every random draw (the
Gumbel noise of `init`, the minibatch indices of `fit_svi`) comes from the
caller's `torch.Generator`, in order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from common_tpu_torch import state as state_mod
from common_tpu_torch import validator
from common_tpu_torch.likelihoods import base as lik_base
from common_tpu_torch.likelihoods import expfam
from common_tpu_torch.likelihoods.bbv import betaln
from common_tpu_torch.rng import gumbel
from common_tpu_torch.state import MixtureState


@dataclass(frozen=True)
class SVIPosterior:
    """Variational posterior over (sticks or weights, cluster params).

    stick_a, stick_b: [K-1] Beta params of q(v_k) (DP mode), or
    dir_conc: [K] Dirichlet concentration of q(w) (fixed-K mode).
    vstats: per-feature pseudo-suffstat dicts with leading [K].
    """

    stick_a: torch.Tensor
    stick_b: torch.Tensor
    dir_conc: torch.Tensor
    vstats: Tuple[Dict[str, torch.Tensor], ...]
    hypers: Tuple[Dict[str, torch.Tensor], ...]
    cluster_hp: Dict[str, torch.Tensor]
    lik_names: Tuple[str, ...] = ()
    fixed: bool = False

    @property
    def k_max(self) -> int:
        return self.dir_conc.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.dir_conc.device

    def likelihoods(self):
        return tuple(lik_base.get(n) for n in self.lik_names)


def _check_expfam(defn):
    for m in defn.models:
        if not m.likelihood.has_expfam:
            raise ValueError(
                f"SVI requires conjugate exponential-family structure; "
                f"{m.likelihood.name!r} does not provide it"
            )


def _mask(mask, x: torch.Tensor) -> torch.Tensor:
    """A column's mask as a tensor on its rows' device (each likelihood
    casts it to its hypers' float type)."""
    return torch.as_tensor(mask, device=x.device)


def init(
    defn,
    data,
    generator: torch.Generator,
    cluster_hp: Optional[Dict[str, Any]] = None,
    feature_hps: Optional[Sequence[Dict[str, Any]]] = None,
    fixed: bool = False,
    init_scale: float = 1.0,
) -> SVIPosterior:
    """Random soft-assignment init (breaks cluster symmetry).

    Draws r = softmax(Gumbel noise) per row on `generator`, then runs one
    full M-step from it: the variational analog of `state.initialize`'s
    CRP draw. The posterior lives on the data's device; its float type
    follows the first column's, as the state's does.
    """
    _check_expfam(defn)
    validator.validate_len(data, defn.nfeatures, "data columns")
    K = defn.k_max
    x0 = data[0][0]
    device, dt = x0.device, state_mod._float_dtype(x0)
    hypers = tuple(
        desc.canonical_hyper(None if feature_hps is None else feature_hps[f],
                             dtype=state_mod._float_dtype(x), device=device)
        for f, (desc, (x, _)) in enumerate(zip(defn.models, data))
    )
    chp = cluster_hp or {}
    if fixed:
        alphas = chp.get("alphas", np.ones(K, np.float32))
        cluster = {"alphas": torch.as_tensor(np.asarray(alphas), device=device).to(dt)}
    else:
        cluster = {"alpha": torch.as_tensor(np.asarray(chp.get("alpha", 1.0)), device=device).to(dt)}

    r = torch.softmax(gumbel((defn.n, K), generator, dt) * init_scale, dim=-1)
    ones = torch.ones(max(K - 1, 1), dtype=dt, device=device)
    post = SVIPosterior(
        stick_a=ones,
        stick_b=ones.clone(),
        dir_conc=torch.ones(K, dtype=dt, device=device),
        vstats=tuple(m.likelihood.init_stats(h, (K,)) for m, h in zip(defn.models, hypers)),
        hypers=hypers,
        cluster_hp=cluster,
        lik_names=tuple(m.name for m in defn.models),
        fixed=fixed,
    )
    return update(post, data, r, rho=1.0, scale=1.0)


# ---------------------------------------------------------------------------
# expectations
# ---------------------------------------------------------------------------
def expected_log_weights(post: SVIPosterior):
    """[K] E_q[log w_k]."""
    if post.fixed:
        c = post.dir_conc
        return torch.digamma(c) - torch.digamma(c.sum())
    if post.k_max == 1:
        return torch.zeros(1, dtype=post.dir_conc.dtype, device=post.device)
    a, b = post.stick_a, post.stick_b
    elog_v = torch.digamma(a) - torch.digamma(a + b)  # [K-1]
    elog_1mv = torch.digamma(b) - torch.digamma(a + b)  # [K-1]
    zero = torch.zeros(1, dtype=a.dtype, device=a.device)
    return torch.cat([zero, torch.cumsum(elog_1mv, 0)]) + torch.cat([elog_v, zero])


def responsibilities(post: SVIPosterior, data):
    """E-step: ([N, K] soft assignments, [N, K] expected log scores)."""
    logp = expected_log_weights(post)[None, :]
    for (x, mask), lik, hyper, vs in zip(data, post.likelihoods(), post.hypers, post.vstats):
        q_k = lik.posterior_hyper(hyper, vs)
        logp = logp + expfam.expected_loglik_table(lik, hyper, q_k, x, _mask(mask, x))
    return torch.softmax(logp, dim=-1), logp


# ---------------------------------------------------------------------------
# M-step / natural-gradient update
# ---------------------------------------------------------------------------
def update(post: SVIPosterior, data, r, rho, scale=1.0) -> SVIPosterior:
    """Blend the new (scaled) global params in at rate rho (rho = 1: CAVI)."""
    K = post.k_max
    nk = scale * r.sum(0)  # [K]

    stick_a, stick_b, dir_conc = post.stick_a, post.stick_b, post.dir_conc
    if not post.fixed and K > 1:
        alpha = post.cluster_hp["alpha"]
        tail = (nk.flip(0).cumsum(0).flip(0) - nk)[: K - 1]  # sum_{j>k} n_j
        stick_a = (1.0 - rho) * stick_a + rho * (1.0 + nk[: K - 1])
        stick_b = (1.0 - rho) * stick_b + rho * (alpha + tail)
    if post.fixed:
        dir_conc = (1.0 - rho) * dir_conc + rho * (post.cluster_hp["alphas"] + nk)

    new_vstats = []
    for (x, mask), lik, hyper, vs in zip(data, post.likelihoods(), post.hypers, post.vstats):
        s_new = lik.stats_from_weights(hyper, x, _mask(mask, x), r)
        new_vstats.append({k: (1.0 - rho) * old + rho * scale * s_new[k] for k, old in vs.items()})
    return dataclasses.replace(post, stick_a=stick_a, stick_b=stick_b, dir_conc=dir_conc,
                               vstats=tuple(new_vstats))


# ---------------------------------------------------------------------------
# ELBO (exact, full batch)
# ---------------------------------------------------------------------------
def _beta_kl(a, b, a0, b0):
    """KL(Beta(a, b) || Beta(a0, b0)) elementwise."""
    dg = torch.digamma
    return (
        betaln(a0, b0) - betaln(a, b)
        + (a - a0) * dg(a)
        + (b - b0) * dg(b)
        + (a0 - a + b0 - b) * dg(a + b)
    )


def _dirichlet_kl(c, c0):
    """KL(Dir(c) || Dir(c0)) over the last axis."""
    cs, c0s = c.sum(-1), c0.sum(-1)
    return (
        torch.lgamma(cs) - torch.lgamma(c0s)
        + (torch.lgamma(c0) - torch.lgamma(c)).sum(-1)
        + ((c - c0) * (torch.digamma(c) - torch.digamma(cs)[..., None])).sum(-1)
    )


def elbo(post: SVIPosterior, data):
    """Exact ELBO at the optimal local q(z) for the current global q."""
    _, logp = responsibilities(post, data)
    # local term: sum_n log sum_k exp(logp_nk) == sum r (logp - log r) at the optimum
    local = torch.logsumexp(logp, dim=-1).sum()
    if post.fixed:
        kl_global = _dirichlet_kl(post.dir_conc, post.cluster_hp["alphas"])
    elif post.k_max > 1:
        kl_global = _beta_kl(post.stick_a, post.stick_b, torch.ones_like(post.stick_a),
                             post.cluster_hp["alpha"]).sum()
    else:
        kl_global = torch.zeros((), dtype=local.dtype, device=local.device)
    for lik, hyper, vs in zip(post.likelihoods(), post.hypers, post.vstats):
        kl_global = kl_global + expfam.kl_k(lik, lik.posterior_hyper(hyper, vs), hyper).sum()
    return local - kl_global


# ---------------------------------------------------------------------------
# fit loops
# ---------------------------------------------------------------------------
def fit_cavi(post: SVIPosterior, data, n_iters: int):
    """Full-batch CAVI: n_iters coordinate-ascent steps.

    Returns (posterior, [n_iters] ELBO trace); the trace stays on the device.
    """
    elbos = []
    for _ in range(int(n_iters)):
        r, _ = responsibilities(post, data)
        post = update(post, data, r, rho=1.0, scale=1.0)
        elbos.append(elbo(post, data))
    return post, torch.stack(elbos)


def fit_svi(post: SVIPosterior, data, generator: torch.Generator, n_iters: int,
            batch_size: int, kappa: float = 0.7, tau: float = 10.0):
    """Minibatch natural-gradient SVI with rho_t = (t + tau)^(-kappa).

    Each step draws `batch_size` row indices (with replacement) on
    `generator`. Returns (posterior, [n_iters] step sizes).
    """
    n = data[0][0].shape[0]
    scale = n / batch_size
    rhos = []
    for t in range(int(n_iters)):
        idx = torch.randint(0, n, (batch_size,), generator=generator, device=generator.device)
        batch = tuple((x[idx], _mask(mask, x)[idx]) for x, mask in data)
        r, _ = responsibilities(post, batch)
        rho = (t + tau) ** (-kappa)
        post = update(post, batch, r, rho=rho, scale=scale)
        rhos.append(rho)
    return post, torch.tensor(rhos)


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------
def to_state(post: SVIPosterior, data) -> MixtureState:
    """Hard-assignment MixtureState (argmax r) for query and checkpoint interop."""
    r, _ = responsibilities(post, data)
    z = torch.argmax(r, dim=-1).to(torch.int32)
    K = post.k_max
    stats = tuple(
        lik.stats_from_assignments(hyper, x, _mask(mask, x), z, K)
        for (x, mask), lik, hyper in zip(data, post.likelihoods(), post.hypers)
    )
    chp = {"alphas": post.cluster_hp["alphas"]} if post.fixed else {"alpha": post.cluster_hp["alpha"]}
    return MixtureState(
        assignments=z, counts=state_mod._assignment_counts(z, K), cluster_hp=chp, stats=stats,
        hypers=post.hypers, lik_names=post.lik_names, fixed=post.fixed,
    )


def predictive_logpdf(post: SVIPosterior, data_row):
    """log p(x_new) under the variational posterior predictive mixture.

    data_row: ((x, mask), ...) for one row. Uses E_q[w_k] weights and each
    cluster's exact posterior predictive at the variational pseudo-stats
    (the standard VB predictive).
    """
    if post.fixed:
        w = post.dir_conc / post.dir_conc.sum()
    else:
        a, b = post.stick_a, post.stick_b
        ev = a / (a + b)
        one = torch.ones(1, dtype=a.dtype, device=a.device)
        w = torch.cat([one, torch.cumprod(1.0 - ev, 0)]) * torch.cat([ev, one])
    logp = torch.log(torch.clamp(w, min=1e-30))
    for (x, mask), lik, hyper, vs in zip(data_row, post.likelihoods(), post.hypers, post.vstats):
        s = lik.pred_logpdf(hyper, vs, torch.as_tensor(x, device=post.device))
        logp = logp + s * torch.as_tensor(mask, device=post.device).to(s.dtype)
    return torch.logsumexp(logp, dim=0)
