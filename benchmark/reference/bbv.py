"""Vector Beta-Bernoulli mixture components and the DP mixture's joint score.

A cluster's D binary columns are independent Bernoulli(p_d) with p_d ~
Beta(alpha_d, beta_d). With n rows and h_d heads in column d,

    log p(x | z) = sum_d [log B(alpha_d + h_d, beta_d + n - h_d) - log B(alpha_d, beta_d)],

and a row's log density given p is x . logit(p) + sum_d log(1 - p_d). The
partition's log probability under the Chinese restaurant process with
concentration alpha over N rows is

    K+ log alpha + sum_{k active} log Gamma(n_k) + log Gamma(alpha) - log Gamma(alpha + N).
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import Precision


def restat(X: torch.Tensor, z: torch.Tensor, K: int, p: Precision):
    """(n [K], heads [K, D]) of binary rows X under z, by one one-hot product."""
    zl = z.to(torch.int64)
    onehot = (zl[:, None] == torch.arange(K, device=z.device)).to(p.dtype)
    return onehot.sum(0), p.mm(onehot.T, X)


def betaln(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _terms(alpha, beta, n, heads, p: Precision) -> torch.Tensor:
    """[K, D] each cluster's and column's log marginal likelihood."""
    a, b, n, h = p(alpha), p(beta), p(n), p(heads)
    t = p(n[:, None] - h)
    return betaln(p(a + h), p(b + t)) - betaln(a, b)


def marginal_loglik(alpha, beta, n, heads, p: Precision) -> torch.Tensor:
    """[K] log marginal likelihood of each cluster's rows."""
    return _terms(alpha, beta, n, heads, p).sum(-1)


def column_loglik(alpha, beta, n, heads, p: Precision) -> torch.Tensor:
    """[D] each column's log marginal likelihood summed over the clusters
    that hold rows: the part of the joint score that a column's hypers move."""
    terms = _terms(alpha, beta, n, heads, p)
    return torch.where((n > 0)[:, None], terms, torch.zeros_like(terms)).sum(0)


def crp_log_prob(counts: torch.Tensor, alpha, p: Precision) -> torch.Tensor:
    """log p(partition) under the CRP with concentration alpha."""
    c, a = p(counts), p(alpha)
    active = c > 0
    return (active.sum().to(p.dtype) * torch.log(a)
            + torch.where(active, torch.lgamma(c), torch.zeros_like(c)).sum()
            + torch.lgamma(a) - torch.lgamma(p(a + c.sum())))


def hyper_target(name: str, v, other, n, heads, log_prior, p: Precision) -> torch.Tensor:
    """A Beta hyper's log target as the slice sampler sees it: log prior(v) plus
    each column's marginal likelihood with hyper `name` ("alpha" or "beta")
    at v [m] and the other at `other` [m], heads [K, m]."""
    a, b = (v, other) if name == "alpha" else (other, v)
    return p(log_prior(v)) + column_loglik(a, b, n, heads, p)


def concentration_target(v, n, log_prior, p: Precision) -> torch.Tensor:
    """The CRP concentration's log target: log prior(v) plus the partition's log probability."""
    return p(log_prior(v)) + crp_log_prob(n, v, p)


def linear_scores(X: torch.Tensor, W: torch.Tensor, base: torch.Tensor, p: Precision) -> torch.Tensor:
    """[N, K] base_k + x_n . w_k."""
    return p.mm(X, W.T) + p(base)
