"""Beta-Negative-Binomial likelihood (port of `common_tpu/likelihoods/bnb.py`).

Reference analog: `distributions:include/distributions/models/bnb.hpp`
(BetaNegativeBinomial), surfaced as the ``bnb`` descriptor in
``common:microscopes/models.py``.

Data: nonnegative int x. p(x | p) = C(x + r - 1, x) p^r (1 - p)^x with
p ~ Beta(alpha, beta); r is a fixed hyper.
Suffstats: (n, sum_x, sum_log_coef = sum log C(x + r - 1, x)).
"""

from __future__ import annotations

import torch

from common_tpu_torch.likelihoods import base
from common_tpu_torch.likelihoods.bbv import betaln
from common_tpu_torch.rng import beta_open, standard_gamma


def _log_nb_coef(x, r):
    return torch.lgamma(x + r) - torch.lgamma(r) - torch.lgamma(x + 1.0)


class BNB(base.Likelihood):
    name = "bnb"
    conjugate = True
    scalar_rows = True

    def default_hyper(self):
        return {"alpha": 1.0, "beta": 1.0, "r": 1.0}

    def init_stats(self, hyper, batch_shape):
        a = hyper["alpha"]
        z = torch.zeros(batch_shape, dtype=a.dtype, device=a.device)
        return {"n": z, "sum_x": z.clone(), "sum_log_coef": z.clone()}

    def tx(self, hyper, x, mask):
        dt = hyper["alpha"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        xf = x.to(dt)
        return {"n": m, "sum_x": m * xf, "sum_log_coef": m * _log_nb_coef(xf, hyper["r"])}

    def posterior_hyper(self, hyper, stats):
        return {
            "alpha": hyper["alpha"] + hyper["r"] * stats["n"],
            "beta": hyper["beta"] + stats["sum_x"],
            "r": hyper["r"],
        }

    def marginal_loglik(self, hyper, stats):
        a, b, r = hyper["alpha"], hyper["beta"], hyper["r"]
        return stats["sum_log_coef"] + betaln(a + r * stats["n"], b + stats["sum_x"]) - betaln(a, b)

    def pred_logpdf(self, hyper, stats, x):
        r = hyper["r"]
        post = self.posterior_hyper(hyper, stats)
        a_n, b_n = post["alpha"], post["beta"]
        xf = x.to(a_n.dtype)
        return _log_nb_coef(xf, r) + betaln(a_n + r, b_n + xf) - betaln(a_n, b_n)

    def sample_params(self, generator, hyper, stats):
        """p ~ Beta(alpha + r n, beta + sum_x), inside (0, 1) (`rng.beta_open`);
        r rides along, one per slot."""
        post = self.posterior_hyper(hyper, stats)
        p = beta_open(post["alpha"], post["beta"], generator)
        return {"p": p, "r": hyper["r"].expand_as(p)}

    def logpdf(self, theta, x):
        p, r = theta["p"], theta["r"]
        xf = x.to(p.dtype)
        return _log_nb_coef(xf, r) + r * torch.log(p) + xf * torch.log1p(-p)

    def logpdf_batch(self, theta, X, mask):
        return self.logpdf(theta, X[:, None]) * mask[:, None]

    def sample_value(self, generator, theta):
        # NB(r, p) as Poisson(Gamma(r) (1 - p) / p): the success-probability
        # convention of p^r (1 - p)^x
        p, r = theta["p"], theta["r"]
        lam = standard_gamma(r.expand_as(p).contiguous(), generator) * (1.0 - p) / p
        return torch.poisson(lam, generator=generator).to(torch.int32)

    def prior_logpdf(self, hyper, theta):
        a, b = hyper["alpha"], hyper["beta"]
        p = theta["p"]
        return (a - 1.0) * torch.log(p) + (b - 1.0) * torch.log1p(-p) - betaln(a, b)


bnb = base.register(BNB())
