"""The extreme-count draws of `tests/test_torch_support.py` and the card case
of `tests/test_torch_cuda.py` (no JAX here, so the card file stays free of it).

DRAWS slots, each with HEADS heads (bnb: HEADS zero counts) and hyper beta
BETA: in float32 about 20% of unclamped Beta draws there are exactly 1.0.
"""

import torch

from common_tpu_torch import likelihoods as tlik

DRAWS, HEADS, BETA = 10_000, 1e6, 0.5
NAMES = ("bb", "bnb", "bbv", "bbnc")


def extreme(name: str, device="cpu"):
    """(likelihood, hyper, stats, rows to score, (a, b) of its Beta draw) of one
    likelihood at the extreme counts."""
    def full(*shape, value):
        return torch.full(shape, float(value), device=device)

    def scalar(value):
        return torch.tensor(float(value), device=device)

    if name == "bbv":
        d = 100
        hyper = {"alpha": full(d, value=1.0), "beta": full(d, value=BETA)}
        stats = {"n": full(DRAWS // d, value=HEADS), "heads": full(DRAWS // d, d, value=HEADS)}
        X = torch.stack([full(d, value=1.0), full(d, value=0.0)])
    elif name == "bnb":
        hyper = {"alpha": scalar(1.0), "beta": scalar(BETA), "r": scalar(1.0)}
        stats = {"n": full(DRAWS, value=HEADS), "sum_x": full(DRAWS, value=0.0), "sum_log_coef": full(DRAWS, value=0.0)}
        X = torch.tensor([0.0, 3.0], device=device)
    else:
        hyper = {"alpha": scalar(1.0), "beta": scalar(BETA)}
        stats = {"n": full(DRAWS, value=HEADS), "heads": full(DRAWS, value=HEADS)}
        if name == "bbnc":
            stats["p"] = full(DRAWS, value=0.5)
        X = torch.tensor([1.0, 0.0], device=device)
    lik = getattr(tlik, name)
    if name == "bbnc":  # non-conjugate: no posterior_hyper, the same conditional
        ab = (hyper["alpha"] + stats["heads"], hyper["beta"] + stats["n"] - stats["heads"])
    else:
        post = lik.posterior_hyper(hyper, stats)
        ab = (post["alpha"], post["beta"])
    return lik, hyper, stats, X, ab


def scores(lik, theta, X):
    """[rows, slots] log-likelihood of X under theta (bbnc, which has no table: its logpdf)."""
    if lik.name == "bbnc":
        return lik.logpdf(theta, X[:, None])
    return lik.logpdf_batch(theta, X, torch.ones(X.shape[0], device=X.device))
