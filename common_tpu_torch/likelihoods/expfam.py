"""Conjugate exponential-family expectations (port of `common_tpu/likelihoods/expfam.py`).

Every variational quantity comes from one function per family, the
conjugate prior's log-partition A(eta), by autodiff:

  E_q[T(theta)]        = grad A(eta_q)                       (mean params)
  E_q[log p(x|theta)]  = t(x) . grad A(eta_q) + log h(x)     (expected loglik)
  KL(q || p)           = (eta_q - eta_p) . grad A(eta_q) - A(eta_q) + A(eta_p)

with q the conjugate family at eta_q (SVI's variational posterior) and p
the prior at eta_p. Each likelihood supplies `nat_params`, `log_partition`,
`suffstat_pair` (t(x), aligned with eta) and `log_h`.

The JAX package vmaps these over the cluster axis. Here the likelihoods'
methods broadcast over a leading [K] axis instead, so E_q[T] of all K
clusters is one `torch.autograd.grad` of sum_k A(eta_k): no loop over
clusters and no vmap. A leaf's event axes are those of the prior's
(unbatched) natural parameters; `kl` and `kl_k` are then one function.
"""

from __future__ import annotations

import torch


def _grad_A(lik, nat):
    """grad A at `nat` (leaves with any leading batch axes), leaf by leaf."""
    keys = sorted(nat)
    leaves = [nat[k].detach().requires_grad_(True) for k in keys]
    with torch.enable_grad():
        total = lik.log_partition(dict(zip(keys, leaves))).sum()
        grads = torch.autograd.grad(total, leaves)
    return dict(zip(keys, grads))


def expected_T(lik, hyper):
    """E_q[T] = grad A(eta(hyper)), a dict shaped like `nat_params(hyper)`;
    hyper's leaves may carry a leading cluster axis [K]."""
    return _grad_A(lik, lik.nat_params(hyper))


def expected_T_k(lik, hyper_q_k):
    """grad A per cluster: hyper_q_k's leaves have a leading [K]."""
    return expected_T(lik, hyper_q_k)


def expected_logpdf(lik, hyper_q, x, mask):
    """E_q[log p(x | theta)] for one row under one q (no batch)."""
    et = expected_T(lik, hyper_q)
    t = lik.suffstat_pair(hyper_q, x, mask)
    return sum((t[k] * et[k]).sum() for k in sorted(et)) + lik.log_h(hyper_q, x, mask)


def _event_sum(t: torch.Tensor, event_ndim: int) -> torch.Tensor:
    """t summed over its last `event_ndim` axes, those of one natural
    parameter (`sum(dim=())` would sum every axis)."""
    return t.sum(tuple(range(-event_ndim, 0))) if event_ndim else t


def kl(lik, hyper_q, hyper_p):
    """KL(q || p) between two members of the conjugate family.

    hyper_q may carry a leading cluster axis [K] (then [K] KLs); hyper_p
    is the prior, without batch axes.
    """
    nat_q, nat_p = lik.nat_params(hyper_q), lik.nat_params(hyper_p)
    g = _grad_A(lik, nat_q)
    dot = sum(
        _event_sum((nat_q[k] - nat_p[k]) * g[k], nat_p[k].dim())
        for k in sorted(g)
    )
    return dot - lik.log_partition(nat_q) + lik.log_partition(nat_p)


def kl_k(lik, hyper_q_k, hyper_p):
    """[K] KL(q_k || prior) for per-cluster variational posteriors."""
    return kl(lik, hyper_q_k, hyper_p)


def _flat(tree, lead: int) -> torch.Tensor:
    """Leaves in sorted-key order (the JAX package's ravel order), each
    flattened past its `lead` axis and concatenated: [lead, S]."""
    return torch.cat([tree[k].reshape(lead, -1) for k in sorted(tree)], dim=-1)


def expected_loglik_table(lik, hyper_p, hyper_q_k, X, mask):
    """[N, K] table of E_q[log p(x_n | theta_k)].

    One product over the flattened suffstat axis S, t(X) [N, S] times
    E[T] [S, K], so the N x K work is a single matmul (at D = 16 for NIW, S
    = 16 + 256 + 2). hyper_p gives t(x) its shapes and float type.
    """
    et_k = expected_T(lik, hyper_q_k)
    k = et_k[sorted(et_k)[0]].shape[0]
    n = X.shape[0]
    tmat = _flat(lik.suffstat_pair(hyper_p, X, mask), n)
    emat = _flat(et_k, k).to(tmat.dtype)
    return tmat @ emat.T + lik.log_h(hyper_p, X, mask)[:, None]
