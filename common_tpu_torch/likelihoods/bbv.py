"""Vector Beta-Bernoulli likelihood (port of `common_tpu/likelihoods/bbv.py`).

d independent binary columns in one feature, with per-column (alpha, beta)
hypers: the reference's d scalar ``bb`` features
(`distributions:include/distributions/models/bb.hpp`) with all d columns
scored in one product,

    log p(x | p_k) = x . (log p_k - log(1 - p_k)) + sum_d log(1 - p_kd),

i.e. ``X @ W.T + b`` with W = logit(p), the form of the linear assignment
kernel (`ops/linear_assign.py`).

Suffstats: (n [K], heads [K, d]). Hyper: alpha [d], beta [d].
"""

from __future__ import annotations

import numpy as np
import torch

from common_tpu_torch.likelihoods import base
from common_tpu_torch.ops.slice_update import KIND_ALPHA, KIND_BETA, HyperTarget, exponential_rate
from common_tpu_torch.rng import beta_open


def _algdiv(a, b):
    """log(Gamma(b) / Gamma(a + b)) for b >= 8 and a <= b.

    The series of scipy's cdflib `algdiv`, as the JAX package uses it
    (jax._src.third_party.scipy.betaln).
    """
    c0, c1, c2 = 0.833333333333333e-01, -0.277777777760991e-02, 0.793650666825390e-03
    c3, c4, c5 = -0.595202931351870e-03, 0.837308034031215e-03, -0.165322962780713e-02
    h = a / b
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = (1.0 / b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t + c1 * s3) * t + c0
    w = w * (x / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def betaln(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log B(a, b), elementwise.

    lgamma(a) + lgamma(b) - lgamma(a + b) while the larger argument is
    below 8; above, scipy's series for the last two terms, which keeps fp32
    accuracy at large counts (as `jax.scipy.special.betaln` does).
    """
    a, b = torch.broadcast_tensors(a, b)
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large_b = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small_b, large_b)


class BBV(base.Likelihood):
    name = "bbv"
    conjugate = True

    def default_hyper(self):
        # d is carried by the hyper arrays themselves
        return {"alpha": np.ones(1), "beta": np.ones(1)}

    def validate_hyper(self, hyper, dtype=torch.float32, device="cuda"):
        missing = {"alpha", "beta"} - set(hyper)
        if missing:
            raise ValueError(f"{self.name}: missing hyperparameters {sorted(missing)}")
        a = base._as_tensor(hyper["alpha"], dtype, device)
        b = base._as_tensor(hyper["beta"], dtype, device)
        if a.shape != b.shape or a.dim() != 1:
            raise ValueError(
                f"{self.name}: alpha/beta must be matching [d] vectors, "
                f"got {tuple(a.shape)} / {tuple(b.shape)}"
            )
        return {"alpha": a, "beta": b}

    def init_stats(self, hyper, batch_shape):
        a = hyper["alpha"]
        kw = dict(dtype=a.dtype, device=a.device)
        return {
            "n": torch.zeros(batch_shape, **kw),
            "heads": torch.zeros((*batch_shape, a.shape[-1]), **kw),
        }

    def tx(self, hyper, x, mask):
        dt = hyper["alpha"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)
        return {"n": m, "heads": m[..., None] * x.to(dt)}

    def stats_from_assignments(self, hyper, X, mask, gid, K):
        """n and heads of each cluster, by one one-hot product; rows with gid
        outside [0, K) or a zero mask drop."""
        dt = hyper["alpha"].dtype
        w = mask.to(dt) * (gid < K)
        onehot = (gid.reshape(-1, 1) == torch.arange(K, device=gid.device)).to(dt) * w[:, None]
        return {"n": onehot.sum(0), "heads": onehot.T @ X.to(dt)}

    def posterior_hyper(self, hyper, stats):
        return {
            "alpha": hyper["alpha"] + stats["heads"],
            "beta": hyper["beta"] + stats["n"][..., None] - stats["heads"],
        }

    # conjugate exponential family: T(p) = (log p, log(1 - p)), column by column
    has_expfam = True

    def nat_params(self, hyper):
        return {"a": hyper["alpha"] - 1.0, "b": hyper["beta"] - 1.0}

    def log_partition(self, nat):
        return betaln(nat["a"] + 1.0, nat["b"] + 1.0).sum(-1)

    def suffstat_pair(self, hyper, x, mask):
        dt = hyper["alpha"].dtype
        m = torch.as_tensor(mask, device=x.device).to(dt)[..., None]
        xf = x.to(dt)
        return {"a": m * xf, "b": m * (1.0 - xf)}

    def log_h(self, hyper, x, mask):
        return torch.zeros(x.shape[:-1], dtype=hyper["alpha"].dtype, device=x.device)

    def hyper_target(self, pname, hyper, stats, counts, prior):
        """alpha or beta under an Exp prior: a column's Beta-Bernoulli term,
        the other hyper fixed."""
        rate = exponential_rate(prior, hyper[pname])
        if rate is None:
            return None
        kind, other = (KIND_ALPHA, hyper["beta"]) if pname == "alpha" else (KIND_BETA, hyper["alpha"])
        return HyperTarget(kind, rate, counts, 0, other, stats["n"], stats["heads"])

    def marginal_loglik(self, hyper, stats):
        a, b = hyper["alpha"], hyper["beta"]
        h = stats["heads"]
        t = stats["n"][..., None] - h
        return torch.sum(betaln(a + h, b + t) - betaln(a, b), dim=-1)

    def predictive(self, hyper, stats):
        """Per-column log predictive probabilities of a 1 and of a 0, [K, d] each."""
        a, b = hyper["alpha"], hyper["beta"]
        h = stats["heads"]
        n = stats["n"][..., None]
        denom = torch.log(a + b + n)
        return {"lp": torch.log(a + h) - denom, "lq": torch.log(b + n - h) - denom}

    def predictive_logpdf(self, pred, X):
        """[M, K] predictive log density of binary rows X [M, d]: two products."""
        x = X.to(pred["lp"].dtype)
        return x @ pred["lp"].T + (1.0 - x) @ pred["lq"].T

    def pred_logpdf(self, hyper, stats, x):
        """Posterior predictive of one row x [d], batched over clusters."""
        return self.predictive_logpdf(self.predictive(hyper, stats), x.reshape(1, -1))[0]

    def sample_params(self, generator, hyper, stats):
        """p ~ Beta(alpha + heads, beta + n - heads) for every cluster and column,
        inside (0, 1) (`rng.beta_open`): with thousands of rows all heads in
        one column, a Beta draw rounds to exactly 1 often enough that log(1 -
        p) would be -inf and the score table NaN.
        """
        post = self.posterior_hyper(hyper, stats)
        return {"p": beta_open(post["alpha"], post["beta"], generator)}

    def logpdf(self, theta, x):
        p = theta["p"]
        x = x.to(p.dtype)
        return torch.sum(x * torch.log(p) + (1.0 - x) * torch.log1p(-p), dim=-1)

    def logpdf_batch(self, theta, X, mask):
        """[N, K] Bernoulli log-likelihood table in the product form; masked rows score 0."""
        x = X.to(theta["p"].dtype)
        lp = torch.log(theta["p"])
        lq = torch.log1p(-theta["p"])
        return (x @ (lp - lq).T + lq.sum(-1)[None, :]) * mask[:, None]

    def sample_value(self, generator, theta):
        p = theta["p"]
        return (torch.rand(p.shape, generator=generator, device=p.device, dtype=p.dtype) < p).to(p.dtype)

    def prior_logpdf(self, hyper, theta):
        a, b = hyper["alpha"], hyper["beta"]
        p = theta["p"]
        return torch.sum((a - 1.0) * torch.log(p) + (b - 1.0) * torch.log1p(-p) - betaln(a, b), dim=-1)


bbv = base.register(BBV())
