"""Normal-Inverse-Chi-Square likelihood (port of `common_tpu/likelihoods/nich.py`).

Reference analog: `distributions:include/distributions/models/nich.hpp`
(NormalInverseChiSq), surfaced as the ``nich`` descriptor in
``common:microscopes/models.py``.

Suffstats: (n, sum_x, sum_xsq); closed-form scalar formulas. Hyper: mu
(prior mean), kappa (mean pseudo-count; the reference's `lambda`), sigmasq
(prior variance), nu (variance pseudo-count).
"""

from __future__ import annotations

import math

import torch

from common_tpu_torch.likelihoods import base
from common_tpu_torch.rng import standard_gamma


def _student_t_logpdf(x, df, loc, scale_sq):
    z2 = (x - loc) ** 2 / scale_sq
    return (
        torch.lgamma((df + 1.0) / 2.0)
        - torch.lgamma(df / 2.0)
        - 0.5 * (torch.log(df) + math.log(math.pi) + torch.log(scale_sq))
        - 0.5 * (df + 1.0) * torch.log1p(z2 / df)
    )


class NICH(base.Likelihood):
    name = "nich"
    conjugate = True
    scalar_rows = True

    def default_hyper(self):
        return {"mu": 0.0, "kappa": 1.0, "sigmasq": 1.0, "nu": 1.0}

    def init_stats(self, hyper, batch_shape):
        mu = hyper["mu"]
        z = torch.zeros(batch_shape, dtype=mu.dtype, device=mu.device)
        return {"n": z, "sum_x": z.clone(), "sum_xsq": z.clone()}

    def tx(self, hyper, x, mask):
        dt = hyper["mu"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        x = x.to(dt)
        return {"n": m, "sum_x": m * x, "sum_xsq": m * x * x}

    def posterior_hyper(self, hyper, stats):
        mu0, kappa, sigmasq, nu = hyper["mu"], hyper["kappa"], hyper["sigmasq"], hyper["nu"]
        n, sx, sxx = stats["n"], stats["sum_x"], stats["sum_xsq"]
        kappa_n = kappa + n
        mu_n = (kappa * mu0 + sx) / kappa_n
        nu_n = nu + n
        # nu_n sigmasq_n = nu sigmasq + (sum x^2 - n xbar^2) + kappa n / kappa_n (xbar - mu0)^2,
        # guarded for n = 0 (an empty cluster's posterior is the prior)
        safe_n = torch.clamp(n, min=1.0)
        xbar = sx / safe_n
        ss = torch.clamp(sxx - safe_n * xbar * xbar, min=0.0)
        extra = ss + (kappa * n / kappa_n) * (xbar - mu0) ** 2
        extra = torch.where(n > 0, extra, torch.zeros_like(extra))
        sigmasq_n = (nu * sigmasq + extra) / nu_n
        return {"mu": mu_n, "kappa": kappa_n, "sigmasq": sigmasq_n, "nu": nu_n}

    # conjugate exponential family over (mu, sigmasq):
    # T = (mu / s2, -1 / (2 s2), -mu^2 / (2 s2), -1/2 log s2),
    # eta = (kappa mu0, nu sigmasq0 + kappa mu0^2, kappa, nu + 3).
    has_expfam = True

    def nat_params(self, hyper):
        mu0, kappa = hyper["mu"], hyper["kappa"]
        return {
            "e1": kappa * mu0,
            "e2": hyper["nu"] * hyper["sigmasq"] + kappa * mu0 * mu0,
            "e3": kappa,
            "e4": hyper["nu"] + 3.0,
        }

    def log_partition(self, nat):
        kappa = nat["e3"]
        nu = nat["e4"] - 3.0
        nu_s0 = nat["e2"] - nat["e1"] * nat["e1"] / kappa
        return (
            0.5 * (math.log(2.0 * math.pi) - torch.log(kappa))
            + torch.lgamma(nu / 2.0)
            + 0.5 * nu * (math.log(2.0) - torch.log(nu_s0))
        )

    def suffstat_pair(self, hyper, x, mask):
        dt = hyper["mu"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt).expand(x.shape)
        xf = x.to(dt)
        return {"e1": m * xf, "e2": m * xf * xf, "e3": m, "e4": m}

    def log_h(self, hyper, x, mask):
        m = torch.as_tensor(mask, device=x.device).to(hyper["mu"].dtype)
        return -0.5 * math.log(2.0 * math.pi) * m

    def marginal_loglik(self, hyper, stats):
        post = self.posterior_hyper(hyper, stats)
        return (
            torch.lgamma(post["nu"] / 2.0)
            - torch.lgamma(hyper["nu"] / 2.0)
            + 0.5 * (torch.log(hyper["kappa"]) - torch.log(post["kappa"]))
            + 0.5 * hyper["nu"] * torch.log(hyper["nu"] * hyper["sigmasq"])
            - 0.5 * post["nu"] * torch.log(post["nu"] * post["sigmasq"])
            - 0.5 * stats["n"] * math.log(math.pi)
        )

    def pred_logpdf(self, hyper, stats, x):
        post = self.posterior_hyper(hyper, stats)
        scale_sq = post["sigmasq"] * (1.0 + post["kappa"]) / post["kappa"]
        return _student_t_logpdf(x.to(scale_sq.dtype), post["nu"], post["mu"], scale_sq)

    def sample_params(self, generator, hyper, stats):
        post = self.posterior_hyper(hyper, stats)
        mu_n = post["mu"]
        # sigma^2 ~ nu_n sigmasq_n / chi2(nu_n)
        chi = 2.0 * standard_gamma((post["nu"] / 2.0).expand_as(mu_n).contiguous(), generator)
        var = post["nu"] * post["sigmasq"] / chi
        z = torch.randn(mu_n.shape, generator=generator, device=mu_n.device, dtype=mu_n.dtype)
        return {"mu": mu_n + torch.sqrt(var / post["kappa"]) * z, "var": var}

    def logpdf(self, theta, x):
        var = theta["var"]
        return -0.5 * (x.to(var.dtype) - theta["mu"]) ** 2 / var - 0.5 * torch.log(2.0 * math.pi * var)

    def logpdf_batch(self, theta, X, mask):
        return self.logpdf(theta, X[:, None]) * mask[:, None]

    def sample_value(self, generator, theta):
        mu = theta["mu"]
        z = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
        return mu + torch.sqrt(theta["var"]) * z

    def prior_logpdf(self, hyper, theta):
        mu0, kappa, sigmasq, nu = hyper["mu"], hyper["kappa"], hyper["sigmasq"], hyper["nu"]
        var = theta["var"]
        half_nu = nu / 2.0
        # scaled inverse chi-square on var, normal on mu
        ics = (
            half_nu * torch.log(half_nu * sigmasq)
            - torch.lgamma(half_nu)
            - (half_nu + 1.0) * torch.log(var)
            - half_nu * sigmasq / var
        )
        norm = -0.5 * kappa * (theta["mu"] - mu0) ** 2 / var - 0.5 * torch.log(2.0 * math.pi * var / kappa)
        return ics + norm


nich = base.register(NICH())
