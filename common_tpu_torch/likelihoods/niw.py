"""Normal-Inverse-Wishart likelihood (port of `common_tpu/likelihoods/niw.py`).

Reference analog: `distributions:include/distributions/models/nw.hpp`,
surfaced as the ``niw`` descriptor. Suffstats are exact sums
``(n, sum_x, sum_xxT)`` with a leading cluster axis; the Student-t
predictive, the marginal likelihood and the posterior draws run for all K
clusters at once from batched Cholesky factorizations.

Hyperparameters (Murphy, "Conjugate Bayesian analysis of the Gaussian"):
  mu0 [D]   prior mean
  kappa     prior pseudo-count on the mean
  psi [D,D] prior scatter matrix
  nu        prior degrees of freedom (> D - 1)

Factorizations use `torch.linalg.cholesky_ex`, which neither raises nor
waits for the device on a matrix that is not positive definite: its `info`
output marks such a matrix instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from common_tpu_torch.likelihoods import base
from common_tpu_torch.ops.gaussian_assign import gaussian_scores
from common_tpu_torch.ops.suffstat import scatter_stats_plain, weighted_stats_plain
from common_tpu_torch.rng import standard_gamma


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _eye_like(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


def _chol(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cholesky_ex(a)[0]


def _chol_logdet(chol):
    """log|A| from its Cholesky factor (batched)."""
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def _trace(a):
    return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)


def multigammaln(a: torch.Tensor, d: int) -> torch.Tensor:
    """log multivariate Gamma_d(a), elementwise over `a`.

    Written out because `torch.special.multigammaln` checks its domain
    with a host round trip.
    """
    j = torch.arange(d, dtype=a.dtype, device=a.device)
    return 0.25 * d * (d - 1) * math.log(math.pi) + torch.lgamma(a[..., None] - 0.5 * j).sum(-1)


class NIW(base.Likelihood):
    name = "niw"
    conjugate = True

    def default_hyper(self):
        # 2-d default; real use passes explicit hypers (models.niw(d))
        return {
            "mu0": np.zeros(2),
            "kappa": 1.0,
            "psi": np.eye(2),
            "nu": 3.0,
        }

    def init_stats(self, hyper, batch_shape):
        mu0 = hyper["mu0"]
        d = mu0.shape[-1]
        kw = dict(dtype=mu0.dtype, device=mu0.device)
        return {
            "n": torch.zeros(batch_shape, **kw),
            "sum_x": torch.zeros((*batch_shape, d), **kw),
            "sum_xxT": torch.zeros((*batch_shape, d, d), **kw),
        }

    def tx(self, hyper, x, mask):
        m = torch.as_tensor(mask, dtype=x.dtype, device=x.device)
        return {"n": m, "sum_x": m * x, "sum_xxT": m * _outer(x, x)}

    def stats_from_assignments(self, hyper, X, mask, gid, K):
        """Suffstats from an assignment vector, in plain tensor ops.

        sum_xxT[k] = X^T diag(w_k) X with w_k the masked one-hot column of
        cluster k (`ops.suffstat.scatter_stats_plain`); never builds
        [N, D, D].
        """
        dt = hyper["mu0"].dtype
        X = X.to(dt)
        w = mask.to(dt) * (gid < K)
        onehot = (gid.reshape(-1, 1) == torch.arange(K, device=gid.device)).to(dt) * w[:, None]
        n = onehot.sum(0)
        sum_x = onehot.T @ X
        sum_xxT = scatter_stats_plain(X, torch.where(w > 0, gid, K), K)
        return {"n": n, "sum_x": sum_x, "sum_xxT": sum_xxT}

    def stats_from_weights(self, hyper, X, mask, r):
        """Soft-weighted suffstats (the SVI M-step), in plain tensor ops.

        sum_xxT[k] = X^T diag(r_k * mask) X, one product per cluster
        (`ops.suffstat.weighted_stats_plain`); never builds [N, D, D] or
        [N, K, D].
        """
        dt = hyper["mu0"].dtype
        X = X.to(dt)
        w = r.to(dt) * mask.to(dt)[:, None]  # [N, K]
        return {"n": w.sum(0), "sum_x": w.T @ X, "sum_xxT": weighted_stats_plain(X, w)}

    # -- conjugate exponential family over (mu, Sigma) ---------------------
    # T(theta) = (Lam mu, -1/2 Lam, -1/2 mu' Lam mu, -1/2 log|Sigma|),
    # eta = (kappa mu0, psi + kappa mu0 mu0', kappa, nu + d + 2).
    # Each broadcasts over a leading cluster axis: kappa [K] lifts to the
    # rank of mu0 [K, D] and psi [K, D, D].
    has_expfam = True

    def nat_params(self, hyper):
        mu0, kappa = hyper["mu0"], hyper["kappa"]
        return {
            "e1": kappa[..., None] * mu0,
            "e2": hyper["psi"] + kappa[..., None, None] * _outer(mu0, mu0),
            "e3": kappa,
            "e4": hyper["nu"] + mu0.shape[-1] + 2.0,
        }

    def log_partition(self, nat):
        d = nat["e1"].shape[-1]
        kappa = nat["e3"]
        nu = nat["e4"] - d - 2.0
        psi = nat["e2"] - _outer(nat["e1"], nat["e1"]) / kappa[..., None, None]
        return (
            0.5 * d * (math.log(2.0 * math.pi) - torch.log(kappa))
            + 0.5 * nu * d * math.log(2.0)
            - 0.5 * nu * torch.linalg.slogdet(psi)[1]
            + multigammaln(nu / 2.0, d)
        )

    def suffstat_pair(self, hyper, x, mask):
        dt = hyper["mu0"].dtype
        x = x.to(dt)
        m = torch.as_tensor(mask, device=x.device).to(dt).expand(x.shape[:-1])
        return {"e1": m[..., None] * x, "e2": m[..., None, None] * _outer(x, x), "e3": m, "e4": m}

    def log_h(self, hyper, x, mask):
        d = hyper["mu0"].shape[-1]
        m = torch.as_tensor(mask, device=x.device).to(hyper["mu0"].dtype)
        return -0.5 * d * math.log(2.0 * math.pi) * m

    # -- posterior NIW parameters from suffstats (broadcasts over batch) --
    def posterior_hyper(self, hyper, stats):
        """Posterior hypers, broadcast over the stats' batch axes.

        The hypers may carry batch axes of their own that broadcast against
        the stats' (kappa [C, 1] and mu0 [C, 1, D] against n [C, K] for C
        chains), so each scalar hyper is lifted to its leaf's rank.
        """
        mu0, kappa, psi, nu = (
            hyper["mu0"], hyper["kappa"], hyper["psi"], hyper["nu"],
        )
        n = stats["n"]
        kappa_n = kappa + n
        mu_n = (kappa[..., None] * mu0 + stats["sum_x"]) / kappa_n[..., None]
        nu_n = nu + n
        psi_n = (
            psi
            + stats["sum_xxT"]
            + kappa[..., None, None] * _outer(mu0, mu0)
            - kappa_n[..., None, None] * _outer(mu_n, mu_n)
        )
        # Symmetrize exactly and add a relative diagonal jitter (1e-6 of the
        # mean diagonal), as the JAX package does against accumulated f32
        # drift. The jitter is gated on n > 0: empty slots hold exact zeros
        # and must keep scoring exactly 0 under marginal_loglik.
        d = psi_n.shape[-1]
        psi_n = 0.5 * (psi_n + psi_n.transpose(-1, -2))
        jitter = 1e-6 * (_trace(psi_n) / d) * (n > 0)
        psi_n = psi_n + jitter[..., None, None] * _eye_like(psi_n)
        return {"mu0": mu_n, "kappa": kappa_n, "psi": psi_n, "nu": nu_n}

    def marginal_loglik(self, hyper, stats):
        d = hyper["mu0"].shape[-1]
        post = self.posterior_hyper(hyper, stats)
        n = stats["n"]
        logdet_psi = _chol_logdet(_chol(hyper["psi"]))
        logdet_psi_n = _chol_logdet(_chol(post["psi"]))
        ml = (
            -0.5 * n * d * math.log(math.pi)
            + multigammaln(post["nu"] / 2.0, d)
            - multigammaln(hyper["nu"] / 2.0, d)
            + 0.5 * hyper["nu"] * logdet_psi
            - 0.5 * post["nu"] * logdet_psi_n
            + 0.5 * d * (torch.log(hyper["kappa"]) - torch.log(post["kappa"]))
        )
        # empty-slot invariant: a slot with no data scores exactly 0
        return torch.where(n > 0, ml, torch.zeros_like(ml))

    def predictive(self, hyper, stats):
        """Student-t predictive factors, batched over the clusters.

        Factor once per state, then score any number of rows with
        `predictive_logpdf`.
        """
        d = hyper["mu0"].shape[-1]
        post = self.posterior_hyper(hyper, stats)
        kappa_n, nu_n = post["kappa"], post["nu"]
        df = nu_n - d + 1.0
        scale = ((kappa_n + 1.0) / (kappa_n * df))[..., None, None] * post["psi"]
        chol = _chol(scale)
        const = (
            torch.lgamma((df + d) / 2.0)
            - torch.lgamma(df / 2.0)
            - 0.5 * d * (torch.log(df) + math.log(math.pi))
            - 0.5 * _chol_logdet(chol)
        )
        return {"mu": post["mu0"], "chol": chol, "df": df, "const": const}

    def predictive_logpdf(self, pred, X):
        """[M, *batch] Student-t log density of rows X [M, D]."""
        d = X.shape[-1]
        dev = X.T - pred["mu"][..., :, None]  # [*batch, D, M]
        y = torch.linalg.solve_triangular(pred["chol"], dev, upper=False)
        quad = (y * y).sum(-2)  # [*batch, M]
        df = pred["df"][..., None]
        lp = pred["const"][..., None] - 0.5 * (df + d) * torch.log1p(quad / df)
        return lp.movedim(-1, 0)

    def pred_logpdf(self, hyper, stats, x):
        """Student-t posterior predictive of one row x [D], batched over clusters."""
        return self.predictive_logpdf(self.predictive(hyper, stats), x.reshape(1, -1))[0]

    # -- explicit-parameter path -----------------------------------------
    def sample_params(self, generator, hyper, stats):
        """theta = (mu, cov Cholesky factor) ~ NIW posterior, batched over clusters.

        Bartlett decomposition: with L = chol(psi_n), A the Bartlett factor
        of Wishart(nu_n, I), M = L @ A^-T satisfies M M^T ~ IW(nu_n, psi_n).
        """
        d = hyper["mu0"].shape[-1]
        post = self.posterior_hyper(hyper, stats)
        mu_n, kappa_n, psi_n, nu_n = (
            post["mu0"], post["kappa"], post["psi"], post["nu"],
        )
        batch = psi_n.shape[:-2]
        kw = dict(generator=generator, device=psi_n.device, dtype=psi_n.dtype)
        # Bartlett factor A: lower-tri, diag_i = sqrt(chi2(nu_n - i)), offdiag N(0,1)
        normals = torch.randn((*batch, d, d), **kw)
        i = torch.arange(d, dtype=psi_n.dtype, device=psi_n.device)
        chi_df = torch.clamp(nu_n[..., None] - i, min=1e-3)
        chi = 2.0 * standard_gamma(chi_df / 2.0, generator)
        A = torch.tril(normals, -1) + torch.diag_embed(torch.sqrt(chi))
        L = _chol(psi_n)
        # M = L @ A^{-T}  (solve A M^T = L^T for M^T; A lower)
        Mt = torch.linalg.solve_triangular(A, L.transpose(-1, -2), upper=False)
        M = Mt.transpose(-1, -2)
        z = torch.randn((*batch, d, 1), **kw)
        mu = mu_n + (M @ z)[..., 0] / torch.sqrt(kappa_n)[..., None]
        # Canonical lower Cholesky factor of Sigma = M M^T. Heavy-tailed
        # prior draws can make the f32 Gram matrix lose definiteness to
        # rounding; those slots (info != 0, or a NaN diagonal) take the
        # factor of Sigma plus a relative diagonal jitter (1e-5 of the mean
        # diagonal). Both factors are computed, so nothing waits on the
        # device to decide.
        sigma = M @ M.transpose(-1, -2)
        chol, info = torch.linalg.cholesky_ex(sigma)
        bad = (info != 0) | torch.isnan(torch.diagonal(chol, dim1=-2, dim2=-1)).any(-1)
        jitter = (1e-5 * _trace(sigma) / d + 1e-30)[..., None, None] * _eye_like(sigma)
        chol2 = _chol(sigma + jitter)
        chol = torch.where(bad[..., None, None], chol2, chol)
        return {"mu": mu, "cov_chol": chol}

    def sample_params_prec(self, generator, hyper, stats):
        """theta = (mu, precision, log|Sigma|, precision square root) ~ NIW posterior.

        The same posterior draw as `sample_params`: it consumes the
        generator in the same order and shapes (the Bartlett normals, the
        chi-square draws, then the mean's normals), so one generator state
        gives the same mu from both. With Sigma = M M^T and M = L A^-T,

            minv = A^T L^-1,   Sigma^-1 = minv^T minv,
            log|Sigma| = 2 sum log diag L - 2 sum log |diag A|,

        so the draw costs one Cholesky (of psi_n) and triangular solves; no
        canonical factor of Sigma is needed by the consumers, which score
        through ||minv (x - mu)||^2 (the multi-chain assignment kernel) or
        the expanded quadratic form (`kernels.blocked._chain_score_table`).
        Batched over any leading axes of the stats. fp32 throughout: the
        expanded form's cancellation amplifies any error in prec.
        """
        d = hyper["mu0"].shape[-1]
        post = self.posterior_hyper(hyper, stats)
        mu_n, kappa_n, psi_n, nu_n = (
            post["mu0"], post["kappa"], post["psi"], post["nu"],
        )
        batch = psi_n.shape[:-2]
        kw = dict(generator=generator, device=psi_n.device, dtype=psi_n.dtype)
        normals = torch.randn((*batch, d, d), **kw)
        i = torch.arange(d, dtype=psi_n.dtype, device=psi_n.device)
        chi_df = torch.clamp(nu_n[..., None] - i, min=1e-3)
        chi = 2.0 * standard_gamma(chi_df / 2.0, generator)
        A = torch.tril(normals, -1) + torch.diag_embed(torch.sqrt(chi))
        z = torch.randn((*batch, d, 1), **kw)
        L = _chol(psi_n)
        Li = torch.linalg.solve_triangular(L, _eye_like(L).expand_as(L), upper=False)
        minv = A.transpose(-1, -2) @ Li
        prec = minv.transpose(-1, -2) @ minv
        prec = 0.5 * (prec + prec.transpose(-1, -2))
        logdet = 2.0 * (
            torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
            - torch.log(torch.diagonal(A, dim1=-2, dim2=-1).abs()).sum(-1)
        )
        # mu = mu_n + M z / sqrt(kappa_n), M z = L (A^-T z)
        y = torch.linalg.solve_triangular(A.transpose(-1, -2), z, upper=True)
        mu = mu_n + (L @ y)[..., 0] / torch.sqrt(kappa_n)[..., None]
        return {"mu": mu, "prec": prec, "logdet": logdet, "minv": minv}

    def logpdf(self, theta, x):
        """Gaussian log density of x [D], broadcast over theta's batch axes."""
        d = x.shape[-1]
        chol = theta["cov_chol"]
        dev = (x - theta["mu"]).expand_as(theta["mu"])[..., None]
        y = torch.linalg.solve_triangular(chol, dev, upper=False)[..., 0]
        return -0.5 * (y * y).sum(-1) - 0.5 * _chol_logdet(chol) - 0.5 * d * math.log(2.0 * math.pi)

    def sample_value(self, generator, theta):
        """x = mu + L z, z ~ N(0, I), for every entry of theta's batch axes."""
        mu = theta["mu"]
        z = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
        return mu + (theta["cov_chol"] @ z[..., None])[..., 0]

    def prior_logpdf(self, hyper, theta):
        """log NIW(mu, Sigma | hyper) with Sigma = cov_chol @ cov_chol^T."""
        d = hyper["mu0"].shape[-1]
        chol = theta["cov_chol"]
        nu, kappa, psi, mu0 = hyper["nu"], hyper["kappa"], hyper["psi"], hyper["mu0"]
        logdet_sigma = _chol_logdet(chol)
        # inverse-Wishart density; trace(Sigma^-1 psi) from two triangular solves
        sol = torch.linalg.solve_triangular(chol, psi.expand_as(chol), upper=False)
        sol = torch.linalg.solve_triangular(chol.transpose(-1, -2), sol, upper=True)
        iw = (
            0.5 * nu * _chol_logdet(_chol(psi))
            - 0.5 * nu * d * math.log(2.0)
            - multigammaln(nu / 2.0, d)
            - 0.5 * (nu + d + 1.0) * logdet_sigma
            - 0.5 * _trace(sol)
        )
        # normal on mu: N(mu0, Sigma / kappa)
        y = torch.linalg.solve_triangular(chol, (theta["mu"] - mu0)[..., None], upper=False)[..., 0]
        norm = (
            -0.5 * kappa * (y * y).sum(-1)
            - 0.5 * logdet_sigma
            + 0.5 * d * (torch.log(kappa) - math.log(2.0 * math.pi))
        )
        return iw + norm

    def logpdf_batch(self, theta, X, mask):
        """[N, K] Gaussian log-likelihood table, one matmul per cluster.

        y = (X - mu_k) @ L_k^{-T}, quad = rowsum(y^2); masked rows score 0.
        """
        d = X.shape[-1]
        chol = theta["cov_chol"]
        binv = torch.linalg.solve_triangular(chol, _eye_like(chol).expand_as(chol), upper=False)
        base_k = -0.5 * _chol_logdet(chol) - 0.5 * d * math.log(2.0 * math.pi)
        return gaussian_scores(X, theta["mu"], binv, base_k) * mask[:, None]


niw = base.register(NIW())
