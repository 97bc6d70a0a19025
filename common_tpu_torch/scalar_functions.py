"""Scalar log-density functions for hyperpriors (port of `common_tpu/scalar_functions.py`).

Rebuild of ``common:include/microscopes/common/scalar_functions.hpp``: small
log-density callables used as hyperpriors by the hyperparameter samplers
(`kernels/slice_.py`). Each returns logp, in float32, given a value or a
hyper dict (a named field is extracted first). The parameters are 0-d CPU
tensors, which combine with a value on any device.
"""

from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _extract(x, field):
    if isinstance(x, dict):
        if field is None:
            if len(x) != 1:
                raise ValueError(
                    f"hyper dict has keys {sorted(x)}; pass field= to select one"
                )
            (x,) = x.values()
        else:
            x = x[field]
    return torch.as_tensor(x).to(torch.float32)


def log_exponential(lam, field=None):
    """log Exp(x | rate lam). The function carries its rate as
    `exponential_rate`, so the slice sampler can evaluate it on the card."""
    lam = _f32(lam)

    def fn(x):
        x = _extract(x, field)
        return torch.log(lam) - lam * x

    fn.exponential_rate = float(lam)
    return fn


def log_normal(mu, var, field=None):
    """log N(x | mu, var)."""
    mu, var = _f32(mu), _f32(var)

    def fn(x):
        x = _extract(x, field)
        return -0.5 * ((x - mu) ** 2 / var + torch.log(2.0 * math.pi * var))

    return fn


def log_gamma(shape, rate, field=None):
    """log Gamma(x | shape, rate)."""
    shape, rate = _f32(shape), _f32(rate)

    def fn(x):
        x = _extract(x, field)
        return shape * torch.log(rate) - torch.lgamma(shape) + (shape - 1.0) * torch.log(x) - rate * x

    return fn


def log_noninformative_beta(field=None):
    """The reference's noninformative prior over (alpha, beta) of a Beta:
    p(a, b) proportional to (a + b)^(-5/2). Expects a dict with 'alpha' and
    'beta' (field ignored)."""

    def fn(x):
        a = torch.as_tensor(x["alpha"]).to(torch.float32)
        b = torch.as_tensor(x["beta"]).to(torch.float32)
        return -2.5 * torch.log(a + b)

    return fn


def sum_fns(*fns):
    """Sum of log-densities (joint independent prior over several fields)."""

    def fn(x):
        return sum(f(x) for f in fns)

    return fn
