"""Normal-Inverse-Wishart mixture components, written from the published math.

Murphy, "Conjugate Bayesian analysis of the Gaussian distribution" (2007),
sections 8-9: with prior NIW(mu0, kappa, psi, nu) and a cluster's
suffstats (n, sum_x, sum_xxT),

    kappa_n = kappa + n,  nu_n = nu + n,
    mu_n    = (kappa mu0 + sum_x) / kappa_n,
    psi_n   = psi + sum_xxT + kappa mu0 mu0^T - kappa_n mu_n mu_n^T,

Sigma ~ IW(psi_n, nu_n), mu | Sigma ~ N(mu_n, Sigma / kappa_n), and the
marginal likelihood (eq. 266) is

    -n D/2 log pi + log Gamma_D(nu_n/2) - log Gamma_D(nu/2)
    + nu/2 log|psi| - nu_n/2 log|psi_n| + D/2 (log kappa - log kappa_n).

Every function takes a `Precision`: float64 for the reference, TF32 for
the control.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.precision import Precision


def restat(X: torch.Tensor, z: torch.Tensor, K: int, p: Precision, rows: int = 65536):
    """(n [K], sum_x [K, D], sum_xxT [K, D, D]) of rows X under z; z outside
    [0, K) counts nowhere. n is exact (a count); the sums are products in `p`,
    one cluster at a time over its own rows, in blocks of `rows`."""
    D = X.shape[1]
    zl = z.to(torch.int64)
    n = torch.bincount(zl[(zl >= 0) & (zl < K)], minlength=K)[:K]
    order = torch.argsort(zl, stable=True)
    bounds = torch.searchsorted(zl[order], torch.arange(K + 1, device=z.device)).tolist()
    sum_x = torch.zeros(K, D, dtype=p.dtype, device=X.device)
    sum_xxT = torch.zeros(K, D, D, dtype=p.dtype, device=X.device)
    for k in range(K):
        for lo in range(bounds[k], bounds[k + 1], rows):
            xk = p(X[order[lo:min(lo + rows, bounds[k + 1])]])
            sum_x[k] += xk.sum(0)
            sum_xxT[k] += p.mm(xk.T, xk)
    return n, sum_x, sum_xxT


def posterior(hyper: dict, n, sum_x, sum_xxT, p: Precision) -> dict:
    """The NIW posterior of each cluster, batched over the leading axes."""
    mu0, kappa, psi, nu = (p(hyper[k]) for k in ("mu0", "kappa", "psi", "nu"))
    n, sum_x, sum_xxT = p(n), p(sum_x), p(sum_xxT)
    kappa_n = kappa + n
    mu_n = p(p(kappa * mu0 + sum_x) / kappa_n[..., None])
    outer0 = kappa * mu0[:, None] * mu0[None, :]
    outer_n = p(kappa_n[..., None, None] * mu_n[..., :, None] * mu_n[..., None, :])
    psi_n = p(psi + sum_xxT + outer0 - outer_n)
    psi_n = 0.5 * (psi_n + psi_n.transpose(-1, -2))
    return {"kappa": kappa_n, "mu": mu_n, "nu": nu + n, "psi": psi_n}


def multigammaln(a: torch.Tensor, d: int) -> torch.Tensor:
    j = torch.arange(d, dtype=a.dtype, device=a.device)
    return 0.25 * d * (d - 1) * math.log(math.pi) + torch.lgamma(a[..., None] - 0.5 * j).sum(-1)


def _logdet(a: torch.Tensor) -> torch.Tensor:
    """log |det a| (LU): a matrix that rounding left indefinite still gives a number."""
    return torch.linalg.slogdet(a)[1]


def marginal_loglik(hyper: dict, n, sum_x, sum_xxT, p: Precision) -> torch.Tensor:
    """[K] log marginal likelihood of each cluster's rows; 0 for an empty cluster."""
    post = posterior(hyper, n, sum_x, sum_xxT, p)
    D = post["mu"].shape[-1]
    kappa, nu = p(hyper["kappa"]), p(hyper["nu"])
    nn = p(n)
    ml = (-0.5 * nn * D * math.log(math.pi)
          + multigammaln(post["nu"] / 2.0, D) - multigammaln(nu / 2.0 + 0.0 * nn, D)
          + 0.5 * nu * _logdet(p(hyper["psi"])) - 0.5 * post["nu"] * _logdet(post["psi"])
          + 0.5 * D * (torch.log(kappa) - torch.log(post["kappa"])))
    return torch.where(nn > 0, ml, torch.zeros_like(ml))


def draw(post: dict, generator: torch.Generator, p: Precision):
    """(mu [K, D], B [K, D, D]) ~ the posterior, with Sigma^-1 = B^T B, or
    None where a psi_n is not positive definite.

    Bartlett: A lower triangular with A_ii = sqrt(chi2(nu_n - i)) and
    standard normals below; with psi_n = L L^T, Sigma = M M^T for
    M = L A^-T, so B = A^T L^-1, and mu = mu_n + M z / sqrt(kappa_n).
    """
    psi, nu = post["psi"], post["nu"]
    K, D = post["mu"].shape
    dev = psi.device
    kw = dict(generator=generator, device=dev, dtype=torch.float64)
    normals = torch.randn((K, D, D), **kw)
    i = torch.arange(D, dtype=torch.float64, device=dev)
    chi = 2.0 * torch._standard_gamma((nu.to(torch.float64)[:, None] - i) / 2.0, generator=generator)
    A = p(torch.tril(normals, -1) + torch.diag_embed(torch.sqrt(chi)))
    L, info = torch.linalg.cholesky_ex(psi)
    if bool((info != 0).any()):
        return None  # psi_n left indefinite by rounding: no draw
    L = p(L)
    eye = torch.eye(D, dtype=p.dtype, device=dev).expand(K, D, D)
    Li = p(torch.linalg.solve_triangular(L, eye, upper=False))
    B = p.mm(A.transpose(-1, -2), Li)
    zz = p(torch.randn((K, D, 1), **kw))
    y = p(torch.linalg.solve_triangular(A.transpose(-1, -2), zz, upper=True))
    mu = post["mu"] + p.mm(L, y)[..., 0] / torch.sqrt(post["kappa"])[:, None]
    return mu, B


def theta_stats(mu: torch.Tensor, B: torch.Tensor, post: dict):
    """(t_mean, t_cov): how far a draw (mu, B), Sigma^-1 = B^T B, lies from
    the float64 posterior `post`, each ~ N(0, 1) for an exact draw.

    With psi_n = C C^T, C^T Sigma^-1 C ~ Wishart(I, nu_n), so tr(B psi_n B^T)
    ~ chi2(nu_n D); and kappa_n ||B (mu - mu_n)||^2 ~ chi2(D). Each sum over
    the clusters is standardised by its chi-square's mean and sd.
    """
    B = B.to(torch.float64)
    K, D = post["mu"].shape
    dev = B @ (mu.to(torch.float64) - post["mu"])[..., None]
    q = (post["kappa"] * (dev[..., 0] ** 2).sum(-1)).sum()
    r = ((B @ post["psi"]) * B).sum((-1, -2)).sum()
    df_q = K * D
    df_r = float(D * post["nu"].sum())
    return (float((q - df_q) / math.sqrt(2.0 * df_q)), float((r - df_r) / math.sqrt(2.0 * df_r)))


def scores(X: torch.Tensor, mu: torch.Tensor, B: torch.Tensor, base: torch.Tensor,
           p: Precision) -> torch.Tensor:
    """[N, K] base_k - 1/2 ||B_k (x_n - mu_k)||^2, one product per cluster."""
    X = p(X)
    cols = []
    for k in range(mu.shape[0]):
        y = p.mm(p(X - p(mu[k])), B[k].T)
        cols.append(p(base[k]) - 0.5 * (y * y).sum(-1))
    return torch.stack(cols, dim=-1)
