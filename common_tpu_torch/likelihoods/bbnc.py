"""Non-conjugate Beta-Bernoulli with an explicit per-cluster p (port of
`common_tpu/likelihoods/bbnc.py`).

Reference analog: ``common:include/microscopes/models/bbnc.hpp``, the model
the reference ships to exercise non-conjugate inference paths: its
score_value uses the current p rather than a closed-form predictive, and
its score_data is the joint log p(p | hyper) + log p(data | p).

The latent p lives inside the suffstat dict as a non-additive leaf (`tx`
contributes zero to it). `kernels/slice_.py` `theta` resamples it against
:meth:`posterior_logpdf_unnorm`, `kernels/gibbs.py` `theta` draws it from
its exact conditional, and :meth:`refresh_latents` redraws it from the
prior on empty slots, so that Neal-8 aux groups score correctly.
"""

from __future__ import annotations

import torch

from common_tpu_torch.likelihoods import base
from common_tpu_torch.likelihoods.bbv import betaln
from common_tpu_torch.rng import beta_open

_EPS = 1e-6


def _safe_p(p):
    return torch.clamp(p, _EPS, 1.0 - _EPS)


class BBNC(base.Likelihood):
    name = "bbnc"
    conjugate = False
    scalar_rows = True
    latent_leaves = ("p",)
    latent_bounds = {"p": (_EPS, 1.0 - _EPS)}

    def default_hyper(self):
        return {"alpha": 1.0, "beta": 1.0}

    def init_stats(self, hyper, batch_shape):
        a = hyper["alpha"]
        z = torch.zeros(batch_shape, dtype=a.dtype, device=a.device)
        # p = 0.5 keeps the scores finite before the first refresh
        return {"n": z, "heads": z.clone(), "p": torch.full_like(z, 0.5)}

    def tx(self, hyper, x, mask):
        dt = hyper["alpha"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        return {"n": m, "heads": m * x.to(dt), "p": torch.zeros_like(m)}  # latent: not additive

    def refresh_latents(self, generator, hyper, stats, refresh_mask):
        """Redraw p ~ Beta(alpha, beta) where refresh_mask is set, inside (0, 1)."""
        p = stats["p"]
        fresh = beta_open(hyper["alpha"].expand_as(p).contiguous(),
                          hyper["beta"].expand_as(p).contiguous(), generator)
        return {**stats, "p": torch.where(refresh_mask, fresh, p)}

    def pred_logpdf(self, hyper, stats, x):
        # score_value under the current explicit latent (bbnc.hpp)
        return self.logpdf(stats, x)

    def marginal_loglik(self, hyper, stats):
        # joint log prior(p) + log lik(data | p)  (score_data)
        p = _safe_p(stats["p"])
        h, t = stats["heads"], stats["n"] - stats["heads"]
        return self.prior_logpdf(hyper, stats) + h * torch.log(p) + t * torch.log1p(-p)

    def posterior_logpdf_unnorm(self, hyper, stats, p):
        """Unnormalized log p(p | data, hyper): the slice target."""
        p = _safe_p(p)
        h, t = stats["heads"], stats["n"] - stats["heads"]
        return (hyper["alpha"] - 1.0 + h) * torch.log(p) + (hyper["beta"] - 1.0 + t) * torch.log1p(-p)

    def sample_params(self, generator, hyper, stats):
        # the exact conditional (the model is conjugate analytically): the
        # exact theta kernel, and the check of the slice kernel; inside (0, 1)
        # as every Beta parameter of the package (`rng.beta_open`)
        a = hyper["alpha"] + stats["heads"]
        b = hyper["beta"] + stats["n"] - stats["heads"]
        return {"p": beta_open(a, b, generator)}

    def logpdf(self, theta, x):
        p = _safe_p(theta["p"])
        x = x.to(p.dtype)
        return x * torch.log(p) + (1.0 - x) * torch.log1p(-p)

    def sample_value(self, generator, theta):
        p = theta["p"]
        return torch.rand(p.shape, generator=generator, device=p.device, dtype=p.dtype) < p

    def prior_logpdf(self, hyper, theta):
        p = _safe_p(theta["p"])
        a, b = hyper["alpha"], hyper["beta"]
        return (a - 1.0) * torch.log(p) + (b - 1.0) * torch.log1p(-p) - betaln(a, b)


bbnc = base.register(BBNC())
