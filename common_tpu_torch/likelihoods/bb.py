"""Beta-Bernoulli likelihood (port of `common_tpu/likelihoods/bb.py`).

Reference analog: `distributions:include/distributions/models/bb.hpp`
(BetaBernoulli), surfaced as the ``bb`` descriptor in
``common:microscopes/models.py``.

Suffstats: (n, heads). Hyper: alpha, beta. The float type follows the
hypers'; `tx` broadcasts over a leading row axis.
"""

from __future__ import annotations

import torch

from common_tpu_torch.likelihoods import base
from common_tpu_torch.likelihoods.bbv import betaln
from common_tpu_torch.rng import beta_open


class BB(base.Likelihood):
    name = "bb"
    conjugate = True
    scalar_rows = True

    def default_hyper(self):
        return {"alpha": 1.0, "beta": 1.0}

    def init_stats(self, hyper, batch_shape):
        a = hyper["alpha"]
        z = torch.zeros(batch_shape, dtype=a.dtype, device=a.device)
        return {"n": z, "heads": z.clone()}

    def tx(self, hyper, x, mask):
        dt = hyper["alpha"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        return {"n": m, "heads": m * x.to(dt)}

    def posterior_hyper(self, hyper, stats):
        return {
            "alpha": hyper["alpha"] + stats["heads"],
            "beta": hyper["beta"] + stats["n"] - stats["heads"],
        }

    # conjugate exponential family: T(p) = (log p, log(1 - p))
    has_expfam = True

    def nat_params(self, hyper):
        return {"a": hyper["alpha"] - 1.0, "b": hyper["beta"] - 1.0}

    def log_partition(self, nat):
        return betaln(nat["a"] + 1.0, nat["b"] + 1.0)

    def suffstat_pair(self, hyper, x, mask):
        dt = hyper["alpha"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        xf = x.to(dt)
        return {"a": m * xf, "b": m * (1.0 - xf)}

    def log_h(self, hyper, x, mask):
        return torch.zeros(x.shape, dtype=hyper["alpha"].dtype, device=x.device)

    def marginal_loglik(self, hyper, stats):
        a, b = hyper["alpha"], hyper["beta"]
        h, t = stats["heads"], stats["n"] - stats["heads"]
        return betaln(a + h, b + t) - betaln(a, b)

    def pred_logpdf(self, hyper, stats, x):
        a, b = hyper["alpha"], hyper["beta"]
        h, n = stats["heads"], stats["n"]
        denom = torch.log(a + b + n)
        x = x.to(h.dtype)
        return x * (torch.log(a + h) - denom) + (1.0 - x) * (torch.log(b + n - h) - denom)

    def sample_params(self, generator, hyper, stats):
        """p ~ Beta(alpha + heads, beta + n - heads), inside (0, 1) (`rng.beta_open`)."""
        post = self.posterior_hyper(hyper, stats)
        return {"p": beta_open(post["alpha"], post["beta"], generator)}

    def logpdf(self, theta, x):
        p = theta["p"]
        x = x.to(p.dtype)
        return x * torch.log(p) + (1.0 - x) * torch.log1p(-p)

    def logpdf_batch(self, theta, X, mask):
        """[N, K]: heads pick log p, tails log(1 - p); masked rows score 0."""
        return self.logpdf(theta, X[:, None]) * mask[:, None]

    def sample_value(self, generator, theta):
        p = theta["p"]
        return torch.rand(p.shape, generator=generator, device=p.device, dtype=p.dtype) < p

    def prior_logpdf(self, hyper, theta):
        a, b = hyper["alpha"], hyper["beta"]
        p = theta["p"]
        return (a - 1.0) * torch.log(p) + (b - 1.0) * torch.log1p(-p) - betaln(a, b)


bb = base.register(BB())
