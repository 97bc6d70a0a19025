"""Gamma-Poisson likelihood (port of `common_tpu/likelihoods/gp.py`).

Reference analog: `distributions:include/distributions/models/gp.hpp`
(GammaPoisson), surfaced as the ``gp`` descriptor in
``common:microscopes/models.py``.

Suffstats: (n, sum_x, sum_log_fact = sum log x!). Hyper: alpha (shape),
inv_beta (rate). The predictive is negative-binomial.
"""

from __future__ import annotations

import torch

from common_tpu_torch.likelihoods import base
from common_tpu_torch.rng import standard_gamma


class GP(base.Likelihood):
    name = "gp"
    conjugate = True
    scalar_rows = True

    def default_hyper(self):
        return {"alpha": 1.0, "inv_beta": 1.0}

    def init_stats(self, hyper, batch_shape):
        a = hyper["alpha"]
        z = torch.zeros(batch_shape, dtype=a.dtype, device=a.device)
        return {"n": z, "sum_x": z.clone(), "sum_log_fact": z.clone()}

    def tx(self, hyper, x, mask):
        dt = hyper["alpha"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        xf = x.to(dt)
        return {"n": m, "sum_x": m * xf, "sum_log_fact": m * torch.lgamma(xf + 1.0)}

    def posterior_hyper(self, hyper, stats):
        return {
            "alpha": hyper["alpha"] + stats["sum_x"],
            "inv_beta": hyper["inv_beta"] + stats["n"],
        }

    # conjugate exponential family: T(lam) = (log lam, -lam)
    has_expfam = True

    def nat_params(self, hyper):
        return {"e1": hyper["alpha"] - 1.0, "e2": hyper["inv_beta"]}

    def log_partition(self, nat):
        shape = nat["e1"] + 1.0
        return torch.lgamma(shape) - shape * torch.log(nat["e2"])

    def suffstat_pair(self, hyper, x, mask):
        dt = hyper["alpha"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt).expand(x.shape)
        return {"e1": m * x.to(dt), "e2": m}

    def log_h(self, hyper, x, mask):
        dt = hyper["alpha"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        return -m * torch.lgamma(x.to(dt) + 1.0)

    def marginal_loglik(self, hyper, stats):
        a, b = hyper["alpha"], hyper["inv_beta"]
        a_n = a + stats["sum_x"]
        b_n = b + stats["n"]
        return (
            a * torch.log(b)
            - a_n * torch.log(b_n)
            + torch.lgamma(a_n)
            - torch.lgamma(a)
            - stats["sum_log_fact"]
        )

    def pred_logpdf(self, hyper, stats, x):
        a_n = hyper["alpha"] + stats["sum_x"]
        b_n = hyper["inv_beta"] + stats["n"]
        xf = x.to(a_n.dtype)
        return (
            torch.lgamma(a_n + xf)
            - torch.lgamma(a_n)
            - torch.lgamma(xf + 1.0)
            + a_n * torch.log(b_n / (b_n + 1.0))
            - xf * torch.log(b_n + 1.0)
        )

    def sample_params(self, generator, hyper, stats):
        """lam ~ Gamma(alpha + sum_x, inv_beta + n), at least finfo.tiny.

        The Gamma draw is at least finfo.tiny, but a draw at that floor over
        a rate above 2^24 (in float32: a small alpha and a cluster of more
        than 1.7e7 zero counts) underflows to 0, and a zero count would then
        score 0 * log 0 = NaN.
        """
        post = self.posterior_hyper(hyper, stats)
        lam = standard_gamma(post["alpha"], generator) / post["inv_beta"]
        return {"lam": lam.clamp_(min=torch.finfo(lam.dtype).tiny)}

    def logpdf(self, theta, x):
        lam = theta["lam"]
        xf = x.to(lam.dtype)
        return xf * torch.log(lam) - lam - torch.lgamma(xf + 1.0)

    def logpdf_batch(self, theta, X, mask):
        return self.logpdf(theta, X[:, None]) * mask[:, None]

    def sample_value(self, generator, theta):
        return torch.poisson(theta["lam"], generator=generator).to(torch.int32)

    def prior_logpdf(self, hyper, theta):
        a, b = hyper["alpha"], hyper["inv_beta"]
        lam = theta["lam"]
        return a * torch.log(b) - torch.lgamma(a) + (a - 1.0) * torch.log(lam) - b * lam


gp = base.register(GP())
