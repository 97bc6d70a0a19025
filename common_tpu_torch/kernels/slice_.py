"""Slice sampling of hyperparameters (port of `common_tpu/kernels/slice_.py`).

Neal (2003): stepping-out, then shrinkage. Reference analog:
`kernels:microscopes/kernels/slice.pyx`: ``slice.theta(state, rng,
tparams)`` resamples non-conjugate per-cluster latents (bbnc's p), and
``slice.hp(state, rng, hparams)`` feature and cluster hyperparameters under
continuous priors. The targets are the package's own scores
(`posterior_logpdf_unnorm`, `marginal_loglik`, the EPPF).

The JAX package runs each loop as a bounded `lax.while_loop`. Here an
update takes one of two routes, chosen by its target:

- a `HyperTarget` (`hp` asks the likelihood's `hyper_target` for one, and
  `state.crp_hyper_target` for the CRP concentration): one launch of
  `ops/slice_update.py` runs the whole update on the card against the
  coordinate's own float64 term, and the host reads nothing (on the CPU
  its plain version runs, testing on the host);
- any other callable: a Python loop whose test reads one device scalar on
  the host, so every target evaluation that decides a branch waits for the
  device.

The caps (16 step-outs a side, 64 shrinks, the update a no-op when the
shrinks run out) and the sequential coordinate scan over vector hypers
are kept on both, so the sampler is the JAX package's. All values stay on
the state's device; each update draws its level's uniform first, with
`uniform_open`.

Under `utils.profiling.recording()` each update is the span
`slice.update`. On the loop, its two step-outs are `slice.step_out` and
its shrinkage `slice.shrink`, the loop tests the reads
`read.slice.step_out` and `read.slice.shrink`, and each target evaluation
counts `slice.evals`. Each `HyperTarget` update counts
`slice.fused_updates` and opens no loop span; on the CPU its plain
version's tests and evaluations are recorded as the loop's reads and
`slice.evals`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch

from common_tpu_torch import state as state_mod
from common_tpu_torch.ops.slice_update import HyperTarget, slice_update
from common_tpu_torch.rng import device_seed, uniform_open
from common_tpu_torch.state import MixtureState
from common_tpu_torch.utils import profiling

_MAX_STEPOUT = 16
_MAX_SHRINK = 64


def slice_sample(generator: torch.Generator, x0, logf: Callable, w: float = 1.0,
                 lower: float = -math.inf, upper: float = math.inf) -> torch.Tensor:
    """Univariate slice-sampling updates of the target density exp(logf).

    Stepping-out with width w (at most _MAX_STEPOUT steps a side, clipped
    to [lower, upper]), then shrinkage (at most _MAX_SHRINK proposals; an
    entry whose proposals run out keeps x0, a no-op that keeps detailed
    balance). x0 is a float32 tensor on the generator's device, 0-d or
    batched: each entry is an independent update of its own target, and
    logf maps a tensor of x0's shape to one of log densities of that shape.
    Every loop test reads one device scalar: whether any entry still moves.
    A `HyperTarget` logf (x0 one value) takes the update on the card instead.
    """
    with profiling.span("slice.update"):
        dev = generator.device
        x0 = torch.as_tensor(x0, device=dev).to(torch.float32)
        shape = x0.shape
        if isinstance(logf, HyperTarget):
            profiling.count("slice.fused_updates")
            level = uniform_open(shape, generator)
            return slice_update(x0, level, device_seed(generator, dev), logf, w, lower, upper,
                                _MAX_STEPOUT, _MAX_SHRINK)
        profiling.count("slice.evals")
        y = logf(x0) + torch.log(uniform_open(shape, generator))  # logf(x0) - Exp(1)
        u = uniform_open(shape, generator)
        L0 = torch.clamp(x0 - u * w, min=lower)
        R0 = torch.clamp(L0 + w, max=upper)

        def step_out(edge, step):
            with profiling.span("slice.step_out"):
                profiling.count("slice.evals")
                grow = logf(edge) > y
                for _ in range(_MAX_STEPOUT):
                    if not profiling.read(grow.any(), "slice.step_out"):
                        break
                    new_edge = torch.where(grow, torch.clamp(edge + step, lower, upper), edge)
                    profiling.count("slice.evals")
                    grow = grow & (logf(new_edge) > y) & (new_edge != edge)
                    edge = new_edge
                return edge

        lo, hi = step_out(L0, -w), step_out(R0, w)
        x, done = x0, torch.zeros(shape, dtype=torch.bool, device=dev)
        with profiling.span("slice.shrink"):
            for _ in range(_MAX_SHRINK):
                xp = lo + uniform_open(shape, generator) * (hi - lo)
                profiling.count("slice.evals")
                ok = ~done & (logf(xp) >= y)
                x = torch.where(ok, xp, x)
                done = done | ok
                if profiling.read(done.all(), "slice.shrink"):
                    break
                left = xp < x0
                lo = torch.where(~done & left, xp, lo)
                hi = torch.where(~done & ~left, xp, hi)
        return x


def theta(state: MixtureState, generator: torch.Generator, w: float = 0.5) -> MixtureState:
    """Slice-resample explicit per-cluster latents (slice.theta).

    For each non-conjugate feature, each latent leaf is updated slot by
    slot against the feature's `posterior_logpdf_unnorm` conditional, all
    K slots in one batched `slice_sample`; empty slots then take fresh
    prior draws through `refresh_latents` (their conditional is the prior,
    and a prior draw mixes at once).
    """
    new_stats = []
    for lik, hyper, stats_f in zip(state.likelihoods(), state.hypers, state.stats):
        if lik.conjugate or not lik.latent_leaves:
            new_stats.append(stats_f)
            continue
        stats_new = dict(stats_f)
        for leaf in lik.latent_leaves:
            lo, hi = getattr(lik, "latent_bounds", {}).get(leaf, (-math.inf, math.inf))

            def logf(v, leaf=leaf):
                return lik.posterior_logpdf_unnorm(hyper, stats_f, v)

            vals = stats_f[leaf]
            stats_new[leaf] = slice_sample(generator, vals, logf, w=w, lower=lo, upper=hi).to(vals.dtype)
        new_stats.append(lik.refresh_latents(generator, hyper, stats_new, state.counts == 0))
    return dataclasses.replace(state, stats=tuple(new_stats))


def hp(state: MixtureState, data, generator: torch.Generator,
       specs: Dict[int, Dict[str, Dict[str, Any]]],
       cluster: Dict[str, Any] | None = None) -> MixtureState:
    """Slice-resample hyperparameters (slice.hp).

    specs: {fid: {param: {'prior': logp fn, 'w': width, 'bounds': (lo, hi)}}}
    for scalar hypers, or [d] vector hypers (bbv's alpha and beta), which
    are updated coordinate by coordinate as a sequential Gibbs scan, each
    coordinate conditioned on the others' updated values. cluster:
    optional {'prior': fn, 'w': float, 'bounds': (lo, hi)} for the CRP
    concentration alpha. Features and parameters go in sorted order.

    With the blocked (uncollapsed) sweep keep the bounds moderate (Beta
    hypers >= 0.5, say): hypers fitted to mixed early-sweep stats otherwise
    make empty-slot prior draws so extreme that the truncated sampler
    collapses to one cluster.

    A hyper vector whose likelihood's `hyper_target` gives a `HyperTarget`
    (bbv's float32 Beta hypers under a `scalar_functions.log_exponential`
    prior), and the CRP concentration where `state.crp_hyper_target` gives
    one, are updated on the card, one target a vector; every other hyper
    takes the host loop.
    """
    del data  # scored from the suffstats alone
    active = state.counts > 0
    liks = state.likelihoods()
    new_hypers = list(state.hypers)
    for fid, params in sorted(specs.items()):
        lik = liks[fid]
        hyper = dict(new_hypers[fid])
        stats = state.stats[fid]

        def score(h):
            ml = lik.marginal_loglik(h, stats)
            return torch.where(active, ml, torch.zeros_like(ml)).sum()

        for pname, spec in sorted(params.items()):
            prior_fn = spec["prior"]
            lo, hi = spec.get("bounds", (-math.inf, math.inf))
            width = spec.get("w", 1.0)
            x0 = hyper[pname]
            target = lik.hyper_target(pname, hyper, stats, state.counts, prior_fn)
            if target is not None:
                hyper[pname] = torch.stack([
                    slice_sample(generator, x0[c], target.column(c), w=width, lower=lo, upper=hi)
                    for c in range(x0.shape[0])])
                continue
            if x0.dim() == 0:
                def logf(v):
                    return prior_fn(v) + score({**hyper, pname: v})

                hyper[pname] = slice_sample(generator, x0, logf, w=width, lower=lo, upper=hi)
                continue
            coords = torch.arange(x0.shape[0], device=x0.device)
            vec = x0
            for c in range(x0.shape[0]):
                def logf_c(v):
                    return prior_fn(v) + score({**hyper, pname: torch.where(coords == c, v, vec)})

                new_v = slice_sample(generator, vec[c], logf_c, w=width, lower=lo, upper=hi)
                vec = torch.where(coords == c, new_v.to(vec.dtype), vec)
            hyper[pname] = vec
        new_hypers[fid] = hyper
    state = dataclasses.replace(state, hypers=tuple(new_hypers))

    if cluster is not None and not state.fixed:
        prior_fn = cluster["prior"]
        lo, hi = cluster.get("bounds", (1e-6, math.inf))
        alpha = state.cluster_hp["alpha"]
        logf_alpha = state_mod.crp_hyper_target(state, prior_fn)
        if logf_alpha is None:
            def logf_alpha(a):
                s = dataclasses.replace(state, cluster_hp={"alpha": a})
                return prior_fn(a) + state_mod.score_assignment(s)

        new_alpha = slice_sample(generator, alpha, logf_alpha, w=cluster.get("w", 1.0),
                                 lower=lo, upper=hi)
        state = dataclasses.replace(state, cluster_hp={"alpha": new_alpha.to(alpha.dtype)})
    return state
