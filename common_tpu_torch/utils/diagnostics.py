"""MCMC convergence diagnostics (port of `common_tpu/utils/diagnostics.py`).

Split-R-hat and bulk ESS over [C, T] traces, as in Gelman et al. (BDA3) and
Vehtari et al. 2021: the autocorrelation by FFT and Geyer's initial
monotone sequence over pair sums. Computed in float32 on the traces'
device; `summarize_traces` returns host numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_chains(chains) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(chains) if not torch.is_tensor(chains) else chains)
    x = x.to(torch.float32)
    return x[None, :] if x.dim() == 1 else x


def _autocov(x: torch.Tensor) -> torch.Tensor:
    """Autocovariance per lag via FFT, along the last axis of x [..., T]."""
    t = x.shape[-1]
    nfft = 2 ** int(np.ceil(np.log2(2 * t)))
    f = torch.fft.rfft(x - x.mean(-1, keepdim=True), nfft)
    acov = torch.fft.irfft(f * torch.conj(f), nfft)[..., :t]
    return acov / t


def ess(chains) -> torch.Tensor:
    """Bulk effective sample size. chains: [C, T] (or [T] for one chain).

    The multi-chain variance decomposition (W, B) and Geyer's initial
    positive sequence truncation over pair sums.
    """
    x = _as_chains(chains)
    c, t = x.shape
    acovs = _autocov(x)  # [C, T]
    within = (acovs[:, 0] * t / (t - 1.0)).mean()
    mean_acov = acovs.mean(0)
    b_over_n = x.mean(1).var(correction=0) if c > 1 else torch.zeros((), device=x.device)
    var_plus = within * (t - 1.0) / t + b_over_n

    rho = 1.0 - (within - mean_acov) / var_plus  # [T], rho[0] ~= 1
    # Geyer: pair sums G_k = rho_2k + rho_2k+1, tau = -1 + 2 sum_k G_k while
    # positive, made monotone
    tmax = t // 2
    pair = rho[0:2 * tmax:2] + rho[1:2 * tmax:2]
    pos = torch.cumprod((pair > 0.0).to(torch.float32), 0)
    pair_mono = torch.cummin(torch.where(pos > 0, pair, torch.zeros_like(pair)), 0).values
    tau = torch.clamp(-1.0 + 2.0 * (pair_mono * pos).sum(), min=1e-3)
    return c * t / tau


def split_rhat(chains) -> torch.Tensor:
    """Split-R-hat. chains: [C, T]; each chain split in half, 2C sequences."""
    x = _as_chains(chains)
    c, t = x.shape
    half = t // 2
    x = torch.stack([x[:, :half], x[:, half:2 * half]], 0).reshape(2 * c, half)
    n = half
    chain_means = x.mean(1)
    chain_vars = x.var(1, correction=1)
    w = chain_vars.mean()
    b = n * chain_means.var(correction=1)
    var_plus = (n - 1.0) / n * w + b / n
    return torch.sqrt(var_plus / w)


def summarize_traces(score_traces) -> dict:
    """Host-side convenience: dict of ESS / R-hat / mean for [C, T] traces."""
    x = np.asarray(score_traces.cpu() if torch.is_tensor(score_traces) else score_traces,
                   np.float32)
    if x.ndim == 1:
        x = x[None, :]
    return {
        "ess": float(ess(x)),
        "rhat": float(split_rhat(x)) if x.shape[0] > 1 else float("nan"),
        "mean": float(x.mean()),
        "std": float(x.std()),
        "nchains": int(x.shape[0]),
        "nsamples": int(x.shape[1]),
    }
