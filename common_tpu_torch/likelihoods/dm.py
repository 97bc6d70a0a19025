"""Dirichlet-Multinomial likelihood (port of `common_tpu/likelihoods/dm.py`).

Reference analog: ``common:include/microscopes/models/dm.hpp``, surfaced as
the ``dm(n)`` descriptor in ``common:microscopes/models.py``.

Data: per-row count vector x [C] with total m = sum x. Suffstats: (n rows,
counts [C], sum_log_coef = sum over rows of the log multinomial
coefficient). Hyper: alphas [C].
"""

from __future__ import annotations

import torch

from common_tpu_torch.likelihoods import base
from common_tpu_torch.likelihoods.dd import DD, dirichlet_log
from common_tpu_torch.rng import gumbel_argmax


def _log_multinomial_coef(x):
    return torch.lgamma(x.sum(-1) + 1.0) - torch.sum(torch.lgamma(x + 1.0), dim=-1)


class DM(base.Likelihood):
    name = "dm"
    conjugate = True

    def default_hyper(self):
        return {"alphas": [1.0, 1.0]}

    def init_stats(self, hyper, batch_shape):
        a = hyper["alphas"]
        kw = dict(dtype=a.dtype, device=a.device)
        return {"n": torch.zeros(batch_shape, **kw),
                "counts": torch.zeros((*batch_shape, a.shape[-1]), **kw),
                "sum_log_coef": torch.zeros(batch_shape, **kw)}

    def tx(self, hyper, x, mask):
        dt = hyper["alphas"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        xf = x.to(dt)
        return {"n": m, "counts": m[..., None] * xf, "sum_log_coef": m * _log_multinomial_coef(xf)}

    def posterior_hyper(self, hyper, stats):
        return {"alphas": hyper["alphas"] + stats["counts"]}

    # conjugate exponential family: T(pi) = log pi, dd's family
    has_expfam = True
    nat_params = DD.nat_params
    log_partition = DD.log_partition

    def suffstat_pair(self, hyper, x, mask):
        dt = hyper["alphas"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        return {"e": m[..., None] * x.to(dt)}

    def log_h(self, hyper, x, mask):
        dt = hyper["alphas"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        return m * _log_multinomial_coef(x.to(dt))

    def marginal_loglik(self, hyper, stats):
        a = hyper["alphas"]
        cnt = stats["counts"]
        a0 = a.sum(-1)
        return (
            stats["sum_log_coef"]
            + torch.sum(torch.lgamma(a + cnt) - torch.lgamma(a), dim=-1)
            + torch.lgamma(a0)
            - torch.lgamma(a0 + cnt.sum(-1))
        )

    def pred_logpdf(self, hyper, stats, x):
        a_n = hyper["alphas"] + stats["counts"]
        xf = x.to(a_n.dtype)
        a0_n = a_n.sum(-1)
        return (
            _log_multinomial_coef(xf)
            + torch.sum(torch.lgamma(a_n + xf) - torch.lgamma(a_n), dim=-1)
            + torch.lgamma(a0_n)
            - torch.lgamma(a0_n + xf.sum(-1))
        )

    def sample_params(self, generator, hyper, stats):
        return {"logp": dirichlet_log(self.posterior_hyper(hyper, stats)["alphas"], generator)}

    def logpdf(self, theta, x):
        xf = x.to(theta["logp"].dtype)
        return _log_multinomial_coef(xf) + torch.sum(theta["logp"] * xf, dim=-1)

    def logpdf_batch(self, theta, X, mask):
        """[N, C] @ [C, K]: a real product for bag-of-words rows."""
        xf = X.to(theta["logp"].dtype)
        return (_log_multinomial_coef(xf)[:, None] + xf @ theta["logp"].T) * mask[:, None]

    def sample_value(self, generator, theta, total_count: int = 1):
        """A multinomial draw of total_count trials, as repeated categorical draws."""
        logp = theta["logp"]
        c = logp.shape[-1]
        idx = gumbel_argmax(logp.expand(total_count, *logp.shape), generator)
        return (idx[..., None] == torch.arange(c, device=logp.device)).to(logp.dtype).sum(0)

    def prior_logpdf(self, hyper, theta):
        a = hyper["alphas"]
        return (
            torch.lgamma(a.sum(-1))
            - torch.sum(torch.lgamma(a), dim=-1)
            + torch.sum((a - 1.0) * theta["logp"], dim=-1)
        )


dm = base.register(DM())
