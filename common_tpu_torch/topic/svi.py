"""Online variational LDA (port of `common_tpu/topic/svi.py`).

Hoffman, Blei & Bach 2010. Mean-field family over a B-doc minibatch:

  q(phi_k)   = Dirichlet(lam_k)          global topic-word      [K, V]
  q(theta_d) = Dirichlet(gamma_d)        local doc-topic        [B, K]
  q(z_dn)    = Cat(phi*)                 implicit (optimal form)

The per-doc E-step is a pair of [B, K] x [K, V] products on dense
bag-of-words count blocks. One inner iteration is

  norm  = exp(Elogtheta) @ exp(Elogbeta)            [B, V]
  gamma = alpha + exp(Elogtheta) * ((c / norm) @ exp(Elogbeta).T)

and the topic-word statistics come from one more product. The global step
is the convex blend lam <- (1-rho) lam + rho (eta + (D/B) sstats). The
products are plain `torch.matmul` in the counts' dtype (TF32 is off, as
importing the package sets).

`fit_cavi` (full batch, rho=1) maximizes the bound by coordinate ascent and
returns the bound after each step; `fit_svi` is the minibatch path. The
JAX package runs both loops as `lax.scan`s; here they are Python loops
that never wait for the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from common_tpu_torch import validator
from common_tpu_torch.rng import standard_gamma


@dataclass(frozen=True)
class LDAPosterior:
    """Variational LDA posterior: q(phi) Dirichlet rows + fixed priors."""

    lam: torch.Tensor    # [K, V]
    alpha: torch.Tensor  # [K] doc-topic prior
    eta: torch.Tensor    # scalar topic-word prior

    @property
    def n_topics(self) -> int:
        return self.lam.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.lam.shape[1]

    def topics(self) -> torch.Tensor:
        """Posterior-mean topic-word distributions [K, V]."""
        return self.lam / self.lam.sum(-1, keepdim=True)


def init(n_topics: int, vocab_size: int, generator: torch.Generator,
         alpha: float = 0.5, eta: float = 0.1) -> LDAPosterior:
    """Random Gamma(100, 100) init of lam (Hoffman's initialization), on the
    generator's device."""
    validator.validate_positive(n_topics, "n_topics")
    validator.validate_positive(vocab_size, "vocab_size")
    dev = generator.device
    lam = standard_gamma(torch.full((n_topics, vocab_size), 100.0, device=dev), generator) / 100.0
    return LDAPosterior(lam=lam, alpha=torch.full((n_topics,), float(alpha), device=dev),
                        eta=torch.tensor(float(eta), device=dev))


def doc_term_matrix(view, vocab_size: int, n_docs: Optional[int] = None) -> torch.Tensor:
    """[D, V] float32 bag-of-words counts from a variadic dataview / TokenData.

    D defaults to the largest doc id + 1 (a read from the device). The flat
    index d * V + w is int64: at 1M docs x 10,000 words it passes 2^31.
    """
    from common_tpu_torch.topic.hdp import TokenData, _segment_count, token_data

    data = view if isinstance(view, TokenData) else token_data(view)
    D = int(n_docs) if n_docs is not None else int(data.doc_ids.max()) + 1
    flat = torch.where((data.mask > 0) & (data.doc_ids < D), data.doc_ids * vocab_size + data.words,
                       D * vocab_size)
    return _segment_count(flat, D * vocab_size).view(D, vocab_size)


def _dir_elog(conc: torch.Tensor) -> torch.Tensor:
    """E[log x] under Dirichlet(conc) along the last axis."""
    return torch.digamma(conc) - torch.digamma(conc.sum(-1, keepdim=True))


def _e_step(elog_beta, counts, alpha, n_inner: int):
    """Optimal (gamma [B, K], sstats [K, V]) for a count block given E[log beta]."""
    e_beta = torch.exp(elog_beta)                                 # [K, V]
    gamma = alpha[None, :] + counts.sum(-1, keepdim=True) / alpha.shape[0]
    for _ in range(int(n_inner)):
        e_theta = torch.exp(_dir_elog(gamma))                     # [B, K]
        norm = e_theta @ e_beta + 1e-30                           # [B, V]
        gamma = alpha[None, :] + e_theta * ((counts / norm) @ e_beta.T)
    e_theta = torch.exp(_dir_elog(gamma))
    norm = e_theta @ e_beta + 1e-30
    sstats = e_beta * (e_theta.T @ (counts / norm))               # [K, V]
    return gamma, sstats


def step(post: LDAPosterior, counts, total_docs, rho, n_inner: int = 25) -> LDAPosterior:
    """One natural-gradient SVI step on a [B, V] count block."""
    _, sstats = _e_step(_dir_elog(post.lam), counts, post.alpha, n_inner)
    lam_hat = post.eta + (total_docs / counts.shape[0]) * sstats
    return dataclasses.replace(post, lam=(1.0 - rho) * post.lam + rho * lam_hat)


def bound(post: LDAPosterior, counts, total_docs=None, n_inner: int = 25) -> torch.Tensor:
    """Variational bound on log p(counts) for the block (Hoffman's form).

    With total_docs given, the global KL term is scaled by B/D so minibatch
    bounds are comparable across batch sizes.
    """
    elog_beta = _dir_elog(post.lam)
    gamma, _ = _e_step(elog_beta, counts, post.alpha, n_inner)
    elog_theta = _dir_elog(gamma)
    # E_q[log p(w | theta, beta)] with optimal q(z): sum c log phinorm
    phinorm = torch.exp(elog_theta) @ torch.exp(elog_beta) + 1e-30
    ll = (counts * torch.log(phinorm)).sum()
    # E[log p(theta|alpha)] - E[log q(theta|gamma)]
    a = post.alpha
    theta_term = (torch.lgamma(a.sum()) - torch.lgamma(a).sum()
                  + ((a[None, :] - gamma) * elog_theta).sum(-1)
                  + torch.lgamma(gamma).sum(-1) - torch.lgamma(gamma.sum(-1))).sum()
    # E[log p(beta|eta)] - E[log q(beta|lam)]
    V, eta, lam = post.vocab_size, post.eta, post.lam
    beta_term = (torch.lgamma(V * eta) - V * torch.lgamma(eta)
                 + ((eta - lam) * elog_beta).sum(-1)
                 + torch.lgamma(lam).sum(-1) - torch.lgamma(lam.sum(-1))).sum()
    scale = 1.0 if total_docs is None else counts.shape[0] / total_docs
    return ll + theta_term + scale * beta_term


def fit_cavi(post: LDAPosterior, counts, n_iters: int, n_inner: int = 25):
    """Full-batch coordinate ascent (rho=1). Returns (posterior, the bound
    after each step [n_iters]), as the JAX package's scan does."""
    D = counts.shape[0]
    bounds = []
    for _ in range(int(n_iters)):
        post = step(post, counts, D, 1.0, n_inner=n_inner)
        bounds.append(bound(post, counts, n_inner=n_inner))
    return post, torch.stack(bounds)


def fit_svi(post: LDAPosterior, counts, generator: torch.Generator, n_iters: int, batch_size: int,
            tau0: float = 64.0, kappa: float = 0.7, n_inner: int = 25) -> LDAPosterior:
    """Minibatch natural-gradient SVI with rho_t = (tau0 + t)^-kappa; each
    batch's docs are drawn uniformly with replacement from `generator`."""
    validator.validate_in_range(kappa, 0.5, 1.0, "kappa")
    D = counts.shape[0]
    for t in range(int(n_iters)):
        idx = torch.randint(0, D, (int(batch_size),), generator=generator, device=generator.device)
        post = step(post, counts[idx.to(counts.device)], D, (tau0 + t) ** (-kappa), n_inner=n_inner)
    return post


def perplexity(post: LDAPosterior, counts, n_inner: int = 25) -> torch.Tensor:
    """exp(- bound / total token count) on a held-out count block."""
    total = counts.sum().clamp(min=1.0)
    return torch.exp(-bound(post, counts, n_inner=n_inner) / total)
