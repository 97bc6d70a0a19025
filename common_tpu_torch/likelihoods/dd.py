"""Dirichlet-Discrete (categorical) likelihood (port of `common_tpu/likelihoods/dd.py`).

Reference analog: `distributions:include/distributions/models/dd.hpp`
(DirichletDiscrete<N>), surfaced as the ``dd(n)`` descriptor in
``common:microscopes/models.py``.

Data: integer category index in [0, C). Suffstats: (n, counts [C]).
Hyper: alphas [C].
"""

from __future__ import annotations

import torch

from common_tpu_torch.likelihoods import base
from common_tpu_torch.rng import gumbel_argmax, standard_gamma


def _onehot(x, c: int, dtype):
    """[..., c] one-hot rows; an index outside [0, c) gives a zero row, as in JAX.

    A comparison, not `one_hot`, which checks its range on the host.
    """
    return (x.to(torch.int64)[..., None] == torch.arange(c, device=x.device)).to(dtype)


def _pick(table, x):
    """table[..., x] for an integer x, broadcast over table's batch axes.

    x is clamped into range, so a masked cell's placeholder value reads a
    finite entry (its score is then masked out) instead of faulting.
    """
    idx = x.to(torch.int64).clamp(0, table.shape[-1] - 1).expand(table.shape[:-1])[..., None]
    return torch.gather(table, -1, idx)[..., 0]


def dirichlet_log(alphas, generator):
    """log of a Dirichlet(alphas) draw over the last axis, from Gamma draws."""
    g = standard_gamma(alphas.contiguous(), generator)
    return torch.log(g) - torch.log(g.sum(-1, keepdim=True))


class DD(base.Likelihood):
    name = "dd"
    conjugate = True

    def default_hyper(self):
        return {"alphas": [1.0, 1.0]}

    def init_stats(self, hyper, batch_shape):
        a = hyper["alphas"]
        kw = dict(dtype=a.dtype, device=a.device)
        return {"n": torch.zeros(batch_shape, **kw),
                "counts": torch.zeros((*batch_shape, a.shape[-1]), **kw)}

    def tx(self, hyper, x, mask):
        a = hyper["alphas"]
        m = torch.as_tensor(mask, device=x.device).to(a.dtype)
        return {"n": m, "counts": m[..., None] * _onehot(x, a.shape[-1], a.dtype)}

    def posterior_hyper(self, hyper, stats):
        return {"alphas": hyper["alphas"] + stats["counts"]}

    # conjugate exponential family: T(pi) = log pi
    has_expfam = True

    def nat_params(self, hyper):
        return {"e": hyper["alphas"] - 1.0}

    def log_partition(self, nat):
        a = nat["e"] + 1.0
        return torch.lgamma(a).sum(-1) - torch.lgamma(a.sum(-1))

    def suffstat_pair(self, hyper, x, mask):
        a = hyper["alphas"]
        m = torch.as_tensor(mask, device=x.device).to(a.dtype)
        return {"e": m[..., None] * _onehot(x, a.shape[-1], a.dtype)}

    def log_h(self, hyper, x, mask):
        return torch.zeros(x.shape, dtype=hyper["alphas"].dtype, device=x.device)

    def marginal_loglik(self, hyper, stats):
        a = hyper["alphas"]
        a0 = a.sum(-1)
        return (
            torch.sum(torch.lgamma(a + stats["counts"]) - torch.lgamma(a), dim=-1)
            + torch.lgamma(a0)
            - torch.lgamma(a0 + stats["n"])
        )

    def pred_logpdf(self, hyper, stats, x):
        a_n = hyper["alphas"] + stats["counts"]
        return torch.log(_pick(a_n, x)) - torch.log(hyper["alphas"].sum(-1) + stats["n"])

    def sample_params(self, generator, hyper, stats):
        return {"logp": dirichlet_log(self.posterior_hyper(hyper, stats)["alphas"], generator)}

    def logpdf(self, theta, x):
        return _pick(theta["logp"], x)

    def logpdf_batch(self, theta, X, mask):
        """[N, K]: column X[n] of each slot's log-probabilities; masked rows score 0."""
        return theta["logp"].index_select(1, X.to(torch.int64)).T * mask[:, None]

    def sample_value(self, generator, theta):
        return gumbel_argmax(theta["logp"], generator).to(torch.int32)

    def prior_logpdf(self, hyper, theta):
        a = hyper["alphas"]
        return (
            torch.lgamma(a.sum(-1))
            - torch.sum(torch.lgamma(a), dim=-1)
            + torch.sum((a - 1.0) * theta["logp"], dim=-1)
        )


dd = base.register(DD())
