"""Truncated stick-breaking weights of a DP mixture (Ishwaran & James 2001).

With K slots, counts n_k and concentration alpha, the blocked Gibbs
sampler's weights given the counts are

    v_k ~ Beta(1 + n_k, alpha + sum_{j>k} n_j),  k < K,
    w_k = v_k prod_{j<k} (1 - v_j),  w_K = prod_{j<K} (1 - v_j),

so sum_k w_k = 1. From log weights, log v_k = log w_k - log sum_{j>=k} w_j
(the mass left before slot k), which stays exact where v_k lies near 1.
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import Precision


def posterior_params(counts: torch.Tensor, alpha) -> tuple:
    """(a [K-1], b [K-1]): the Beta parameters of each stick but the last."""
    c = counts.to(torch.float64)
    after = c.flip(-1).cumsum(-1).flip(-1) - c
    a = 1.0 + c[..., :-1]
    b = torch.as_tensor(alpha, dtype=torch.float64, device=c.device) + after[..., :-1]
    return a, b


def log_sticks(logw: torch.Tensor) -> torch.Tensor:
    """[K-1] log v_k recovered from log weights [K], in float64."""
    lw = logw.to(torch.float64)
    left = lw.flip(-1).logcumsumexp(-1).flip(-1)  # log sum_{j>=k} w_j
    return (lw - left)[..., :-1]


def stick_z(logw: torch.Tensor, counts: torch.Tensor, alpha) -> torch.Tensor:
    """[K-1] each stick's log v_k standardised by its Beta posterior's mean
    and sd of log v (digamma and trigamma), ~ N(0, 1) for a slot with many rows."""
    a, b = posterior_params(counts, alpha)
    mean = torch.digamma(a) - torch.digamma(a + b)
    var = torch.polygamma(1, a) - torch.polygamma(1, a + b)
    return (log_sticks(logw) - mean) / torch.sqrt(var)


def draw(counts: torch.Tensor, alpha, generator: torch.Generator, p: Precision) -> torch.Tensor:
    """[K] log weights drawn given the counts, each stick a ratio of two
    Gamma draws, the arithmetic in precision p."""
    a, b = posterior_params(counts, alpha)
    kw = dict(generator=generator)
    ga = p(torch._standard_gamma(a, **kw))
    gb = p(torch._standard_gamma(b, **kw))
    v = p(ga / p(ga + gb))
    log_v, log_1mv = p(torch.log(v)), p(torch.log1p(-v))
    before = p(torch.cumsum(log_1mv, -1))
    head = log_v + torch.cat([torch.zeros_like(before[..., :1]), before[..., :-1]], -1)
    return torch.cat([p(head), before[..., -1:]], -1)
