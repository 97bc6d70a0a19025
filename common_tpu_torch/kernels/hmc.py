"""Hamiltonian Monte Carlo and NUTS (port of `common_tpu/kernels/hmc.py`).

For the non-conjugate parts of a mixture: feature hyperparameters given
the suffstats (`hp`, BASELINE config 3), the CRP concentration through the
EPPF (`cluster_hp`) and explicit cluster latents such as bbnc's p
(`theta`). Gradients come from `torch.autograd.grad` through the port's own
scoring functions (`marginal_loglik`, `score_assignment`,
`posterior_logpdf_unnorm`): no derivative is written by hand.

Contents, as in the JAX package:
  - bijectors (identity, positive, lower_bounded, interval) with log-det
    corrections, so sampling happens in unconstrained space;
  - `leapfrog`, `hmc_step` (fixed-length HMC with a Metropolis test);
  - `nuts_step`: iterative multinomial NUTS with biased progressive
    sampling, checkpoint-buffer U-turn checks (the recursion-free
    formulation) and the divergence guard at Delta H > 1000;
  - dual averaging of the step size (Hoffman & Gelman 2014, 3.2) and a
    Welford diagonal mass estimate: `warmup`, `sample`;
  - the mixture kernels `hp`, `cluster_hp`, `theta` behind the runner's
    `nuts_hp`, `nuts_cluster_hp`, `nuts_theta`.

Where the JAX tree is a `lax.while_loop`, the port runs a Python loop
whose position, momentum, gradient and checkpoint buffers stay on the
state's device. The leaf count, the depth and the checkpoint indices are
Python ints. A transition reads from the device its max_depth directions
once, **one boolean per leaf** (did this leaf turn or diverge: the
subtree's stop test) and **one per doubling** that did not stop inside its
subtree (the merged tree's U-turn test): as many reads as the trajectory
has leaves and doublings, plus one. The alternative, all 2^max_depth - 1
leaves run masked with no read, costs the full trajectory on every
transition; at config 3's hyper target a transition as shipped took
225-287 ms (19.8 leaves, 24.6 reads) where 31 leaves issued with no read
took 239-501 ms, and a read cost 0.03-0.05 ms over its launch (NVIDIA
H100 80GB HBM3, 700 W, `chip_smoke.py` phase 9), so the reads stay. The proposals'
swaps are `torch.where`s on the device. A leaf costs one value-and-gradient
evaluation: the gradient at a trajectory's edge is carried with it (the
JAX package evaluates it twice a leaf).

Precision: the position takes the float type of the state (fp32 on the
card, as the JAX package casts it, hmc.py:577; float64 where the caller
builds the state in float64, as the CPU tests do). Streams: every function
takes a `torch.Generator` and consumes it in order (the momentum, the
max_depth directions, then per doubling one uniform a leaf and one for the
subtree's take); the JAX package's `fold_in` tree is not reproduced, so
compare distributions, not draws.

Under `utils.profiling.recording()` `nuts_step`'s reads are the spans
`read.hmc.directions`, `read.hmc.leaf`, `read.hmc.doubling` and (a tensor
step size) `read.hmc.step_size`: as many as its `NUTSInfo.reads`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from common_tpu_torch import state as state_mod
from common_tpu_torch.state import MixtureState
from common_tpu_torch.utils import profiling

_MAX_DELTA_ENERGY = 1000.0  # divergence threshold (Stan's default)


# ---------------------------------------------------------------------------
# bijectors: unconstrained u -> constrained x, with log|dx/du|
# ---------------------------------------------------------------------------
IDENTITY = ("identity",)
POSITIVE = ("positive",)


def lower_bounded(lb):
    return ("lower_bounded", float(lb))


def interval(lo, hi):
    return ("interval", float(lo), float(hi))


def bij_forward(spec, u):
    """(x, sum log|dx/du|) for one leaf."""
    kind = spec[0]
    if kind == "identity":
        return u, torch.zeros((), dtype=u.dtype, device=u.device)
    if kind == "positive":
        return torch.exp(u), u.sum()
    if kind == "lower_bounded":
        return spec[1] + torch.exp(u), u.sum()
    if kind == "interval":
        lo, hi = spec[1], spec[2]
        x = lo + (hi - lo) * torch.sigmoid(u)
        ld = (math.log(hi - lo) + F.logsigmoid(u) + F.logsigmoid(-u)).sum()
        return x, ld
    raise ValueError(f"unknown bijector {spec!r}")


def bij_inverse(spec, x):
    kind = spec[0]
    if kind == "identity":
        return x
    if kind == "positive":
        return torch.log(x)
    if kind == "lower_bounded":
        return torch.log(x - spec[1])
    if kind == "interval":
        lo, hi = spec[1], spec[2]
        s = torch.clamp((x - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
        return torch.log(s) - torch.log1p(-s)
    raise ValueError(f"unknown bijector {spec!r}")


# ---------------------------------------------------------------------------
# flat positions (the JAX package's ravel_pytree, for nested dicts of tensors)
# ---------------------------------------------------------------------------
def ravel(tree) -> Tuple[torch.Tensor, Callable]:
    """(flat vector, unravel) for a tensor or a nested dict of tensors,
    leaves in sorted-key order."""
    leaves, paths = [], []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            leaves.append(torch.as_tensor(t))
            paths.append(path)

    walk(tree, ())
    shapes = [l.shape for l in leaves]
    flat = torch.cat([l.reshape(-1) for l in leaves])

    def unravel(q):
        if not paths[0]:
            return q.reshape(shapes[0])
        out, at = {}, 0
        for path, shape in zip(paths, shapes):
            size = math.prod(shape)
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = q[at:at + size].reshape(shape)
            at += size
        return out

    return flat, unravel


def value_and_grad(logprob_fn: Callable) -> Callable:
    """q -> (logprob(q), grad logprob(q)), both detached."""

    def vg(q):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = logprob_fn(q)
            (g,) = torch.autograd.grad(lp, q)
        return lp.detach(), g

    return vg


# ---------------------------------------------------------------------------
# leapfrog + energies (flat vectors; diagonal inverse mass m_inv)
# ---------------------------------------------------------------------------
def _kinetic(p, m_inv):
    return 0.5 * torch.dot(p, p * m_inv)


def leapfrog(grad_fn, q, p, eps, m_inv, n_steps):
    """n_steps leapfrog steps; returns (q, p). eps may be negative."""
    for _ in range(int(n_steps)):
        p = p + 0.5 * eps * grad_fn(q)
        q = q + eps * (m_inv * p)
        p = p + 0.5 * eps * grad_fn(q)
    return q, p


def _leaf(vg, q, p, g, eps: float, m_inv):
    """One leapfrog step from (q, p) with g = grad logp(q) carried in:
    returns (q', p', logp(q'), grad logp(q')), one evaluation."""
    p = torch.add(p, g, alpha=0.5 * eps)
    q = torch.addcmul(q, m_inv, p, value=eps)
    logp, g = vg(q)
    return q, torch.add(p, g, alpha=0.5 * eps), logp, g


def _momentum(q, m_inv, generator):
    return torch.randn(q.shape, generator=generator, device=q.device, dtype=q.dtype) / torch.sqrt(m_inv)


def _uniform(q, generator, n=()):
    return torch.rand(n, generator=generator, device=q.device, dtype=q.dtype)


# ---------------------------------------------------------------------------
# fixed-length HMC step (Metropolis accept)
# ---------------------------------------------------------------------------
class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor
    diverging: torch.Tensor
    energy: torch.Tensor
    num_leapfrog: int


def hmc_step(logprob_fn, q, generator, step_size, num_leapfrog, m_inv=None):
    """One HMC transition on flat vector q. Returns (q', logp', info); no host read."""
    if m_inv is None:
        m_inv = torch.ones_like(q)
    vg = value_and_grad(logprob_fn)
    eps = float(step_size)  # a read where the step size is a tensor (warmup's)
    p0 = _momentum(q, m_inv, generator)
    logp0, g = vg(q)
    h0 = -logp0 + _kinetic(p0, m_inv)
    q1, p1 = q, p0
    logp1 = logp0
    for _ in range(int(num_leapfrog)):
        q1, p1, logp1, g = _leaf(vg, q1, p1, g, eps, m_inv)
    h1 = -logp1 + _kinetic(p1, m_inv)
    delta = h0 - h1
    delta = torch.where(torch.isnan(delta), -torch.inf, delta)
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    accept = _uniform(q, generator) < accept_prob
    info = HMCInfo(accept_prob, -delta > _MAX_DELTA_ENERGY, h1, int(num_leapfrog))
    return torch.where(accept, q1, q), torch.where(accept, logp1, logp0), info


# ---------------------------------------------------------------------------
# iterative NUTS
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Tree:
    """A trajectory: its two edges (position, momentum, gradient), the
    multinomial proposal, log sum of the leaves' weights exp(H0 - H), the
    momentum sum, and the stop flags. Tensors on the device, but
    `num_leaves` (a Python int)."""

    q_left: torch.Tensor
    p_left: torch.Tensor
    g_left: torch.Tensor
    q_right: torch.Tensor
    p_right: torch.Tensor
    g_right: torch.Tensor
    q_prop: torch.Tensor
    logp_prop: torch.Tensor
    log_weight: torch.Tensor
    p_sum: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: int


def _is_turning(m_inv, p_left, p_right, p_sum):
    """U-turn test; batched over leading axes of p_left (the checkpoints)."""
    v_sum_l = (m_inv * p_sum * p_left).sum(-1)
    v_sum_r = (m_inv * p_sum * p_right).sum(-1)
    return (v_sum_l <= 0.0) | (v_sum_r <= 0.0)


def _leaf_to_ckpt_idxs(n: int) -> Tuple[int, int]:
    """Checkpoint index range to test a new odd leaf n against.

    idx_max = popcount(n >> 1); idx_min = idx_max - (trailing ones of n) + 1.
    (Recursion-free U-turn bookkeeping of the iterative NUTS construction.)
    """
    idx_max = bin(n >> 1).count("1")
    ntrail = 0
    while (n >> ntrail) & 1:
        ntrail += 1
    return idx_max - ntrail + 1, idx_max


def _iterative_turning(m_inv, p_ckpts, psum_ckpts, p, p_sum, idx_min, idx_max):
    """Whether any checkpointed subtree [idx_min, idx_max] ending at this
    leaf turns: every span at once (the JAX loop stops at the first)."""
    pk = p_ckpts[idx_min:idx_max + 1]
    sub_sum = p_sum - psum_ckpts[idx_min:idx_max + 1] + pk
    return _is_turning(m_inv, pk, p, sub_sum).any()


def _build_subtree(vg, q0, p0, g0, eps: float, m_inv, h0, logu, max_depth):
    """A subtree of up to len(logu) leaves by single leapfrog steps from
    (q0, p0), with checkpoint-buffer U-turn checks; logu holds one log
    uniform a leaf for the multinomial swaps. Reads one boolean a leaf
    (turning or diverging). Returns (tree, stopped): its build-order start
    and end sit in left and right; eps carries the direction's sign.
    """
    dim = q0.shape[0]
    p_ckpts = torch.zeros((max_depth + 1, dim), dtype=q0.dtype, device=q0.device)
    psum_ckpts = torch.zeros_like(p_ckpts)
    neg_inf = torch.full((), -torch.inf, dtype=q0.dtype, device=q0.device)
    false = torch.zeros((), dtype=torch.bool, device=q0.device)
    tree = _Tree(q0, p0, g0, q0, p0, g0, q0, neg_inf, neg_inf, torch.zeros_like(p0),
                 false, false, torch.zeros((), dtype=q0.dtype, device=q0.device), 0)
    q, p, g = q0, p0, g0
    for n in range(logu.shape[0]):
        q, p, logp, g = _leaf(vg, q, p, g, eps, m_inv)
        h = torch.nan_to_num(_kinetic(p, m_inv) - logp, nan=torch.inf, posinf=torch.inf, neginf=-torch.inf)
        log_w = h0 - h
        diverging = log_w < -_MAX_DELTA_ENERGY
        new_log_weight = torch.logaddexp(tree.log_weight, log_w)
        # multinomial within-subtree proposal swap
        take_new = logu[n] < (log_w - new_log_weight)
        p_sum = tree.p_sum + p
        if n % 2 == 0:
            idx = _leaf_to_ckpt_idxs(n)[1]
            p_ckpts[idx] = p
            psum_ckpts[idx] = p_sum
            turning = false
        else:
            turning = _iterative_turning(m_inv, p_ckpts, psum_ckpts, p, p_sum,
                                         *_leaf_to_ckpt_idxs(n))
        tree = _Tree(tree.q_left, tree.p_left, tree.g_left, q, p, g,
                     torch.where(take_new, q, tree.q_prop), torch.where(take_new, logp, tree.logp_prop),
                     new_log_weight, p_sum, turning, diverging,
                     tree.sum_accept + torch.clamp(torch.exp(log_w), max=1.0), n + 1)
        if profiling.read(turning | diverging, "hmc.leaf"):  # the one read of this leaf
            return tree, True
    return tree, False


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # mean leaf acceptance (the adaptation statistic)
    diverging: torch.Tensor
    num_leaves: int
    depth: int
    reads: int  # host reads of device values in this transition


def nuts_step(logprob_fn, q, generator, step_size, m_inv=None, max_depth: int = 8):
    """One NUTS transition on flat vector q. Returns (q', logp', info).

    Draws, in order: the momentum; the max_depth directions (one read for
    all); per doubling, one uniform a leaf of the subtree and one for its
    take. A step size given as a tensor (warmup's) costs one more read.
    """
    if m_inv is None:
        m_inv = torch.ones_like(q)
    vg = value_and_grad(logprob_fn)
    if isinstance(step_size, (int, float)):
        step = float(step_size)
    else:
        step = profiling.read(step_size, "hmc.step_size")
    p0 = _momentum(q, m_inv, generator)
    logp0, g0 = vg(q)
    h0 = _kinetic(p0, m_inv) - logp0
    rights = _uniform(q, generator, (max_depth,)) < 0.5
    with profiling.span("read.hmc.directions"):
        rights = rights.tolist()
    false = torch.zeros((), dtype=torch.bool, device=q.device)
    tree = _Tree(q, p0, g0, q, p0, g0, q, logp0, torch.zeros_like(logp0), p0, false, false,
                 torch.zeros_like(logp0), 1)
    depth, reads = 0, 1 + (not isinstance(step_size, (int, float)))
    while depth < max_depth:
        right = rights[depth]
        logu = torch.log(_uniform(q, generator, (2 ** depth + 1,)))
        edge = (tree.q_right, tree.p_right, tree.g_right) if right else (tree.q_left, tree.p_left, tree.g_left)
        sub, bad = _build_subtree(vg, *edge, step if right else -step, m_inv, h0, logu[:-1], max_depth)
        reads += sub.num_leaves
        # the subtree's build end is the new outer edge
        end = (sub.q_right, sub.p_right, sub.g_right)
        if right:
            left_edge, right_edge = (tree.q_left, tree.p_left, tree.g_left), end
        else:
            left_edge, right_edge = end, (tree.q_right, tree.p_right, tree.g_right)
        p_sum = tree.p_sum + sub.p_sum
        turning = sub.turning | sub.diverging
        if not bad:
            # biased progressive sampling: P(take the subtree's proposal) = min(1, w_sub / w_tree)
            take = logu[-1] < (sub.log_weight - tree.log_weight)
            q_prop = torch.where(take, sub.q_prop, tree.q_prop)
            logp_prop = torch.where(take, sub.logp_prop, tree.logp_prop)
            turning = _is_turning(m_inv, left_edge[1], right_edge[1], p_sum)
        else:
            q_prop, logp_prop = tree.q_prop, tree.logp_prop
        tree = _Tree(*left_edge, *right_edge, q_prop, logp_prop,
                     torch.logaddexp(tree.log_weight, sub.log_weight), p_sum, turning,
                     tree.diverging | sub.diverging, tree.sum_accept + sub.sum_accept,
                     tree.num_leaves + sub.num_leaves)
        depth += 1
        if bad or depth == max_depth:
            break
        reads += 1
        if profiling.read(turning, "hmc.doubling"):  # the doubling's read
            break
    info = NUTSInfo(tree.sum_accept / max(tree.num_leaves - 1, 1), tree.diverging, tree.num_leaves,
                    depth, reads)
    return tree.q_prop, tree.logp_prop, info


# ---------------------------------------------------------------------------
# dual-averaging step-size adaptation (HG14 3.2) + Welford mass
# ---------------------------------------------------------------------------
class DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def da_init(step_size, dtype=torch.float32, device="cuda"):
    eps = torch.as_tensor(step_size, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    return DAState(torch.log(eps), torch.log(eps), zero, torch.log(10.0 * eps), zero)


def da_update(s: DAState, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75) -> DAState:
    t = s.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_avg = (1.0 - eta_h) * s.h_avg + eta_h * (target - accept_prob)
    log_eps = s.mu - torch.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * s.log_eps_avg
    return DAState(log_eps, log_eps_avg, h_avg, s.mu, t)


class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def welford_init(dim, dtype=torch.float32, device="cuda"):
    z = torch.zeros(dim, dtype=dtype, device=device)
    return WelfordState(z, z, torch.zeros((), dtype=dtype, device=device))


def welford_update(s: WelfordState, x) -> WelfordState:
    count = s.count + 1.0
    delta = x - s.mean
    mean = s.mean + delta / count
    m2 = s.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_var(s: WelfordState, regularize=True):
    var = s.m2 / torch.clamp(s.count - 1.0, min=1.0)
    if regularize:  # Stan's shrink-to-unit regularization
        w = s.count / (s.count + 5.0)
        var = w * var + (1.0 - w) * 1e-3
    return var


# ---------------------------------------------------------------------------
# warmup + sample over flat or dict positions
# ---------------------------------------------------------------------------
def warmup(logprob_flat, q0, generator, num_steps, init_step_size=0.1,
           max_depth=8, target_accept=0.8, adapt_mass=True):
    """Dual-averaging (+ optional Welford diagonal mass) NUTS warmup.

    Returns (q, step_size, m_inv). One adaptation window: the mass is
    estimated from all warmup draws and applied at the end, then the step
    size is re-adapted under it for max(num_steps // 4, 10) transitions.
    """
    kw = dict(dtype=q0.dtype, device=q0.device)
    q, da, wf = q0, da_init(init_step_size, **kw), welford_init(q0.shape[0], **kw)
    for _ in range(int(num_steps)):
        q, _, info = nuts_step(logprob_flat, q, generator, torch.exp(da.log_eps), None, max_depth)
        da = da_update(da, info.accept_prob, target=target_accept)
        wf = welford_update(wf, q)
    m_inv = welford_var(wf) if adapt_mass else torch.ones_like(q0)

    da = da_init(torch.exp(da.log_eps_avg), **kw)
    for _ in range(max(int(num_steps) // 4, 10)):
        q, _, info = nuts_step(logprob_flat, q, generator, torch.exp(da.log_eps), m_inv, max_depth)
        da = da_update(da, info.accept_prob, target=target_accept)
    return q, torch.exp(da.log_eps_avg), m_inv


def sample(logprob_fn, init_position, generator, num_samples, num_warmup=500,
           kernel="nuts", step_size=0.1, num_leapfrog=32, max_depth=8,
           target_accept=0.8):
    """Warmup + sample. init_position: a tensor or a nested dict of tensors
    (its float type is the chain's); returns the stacked draws, shaped like
    it with a leading [num_samples], and an info dict of [num_samples]
    tensors plus the adapted step size."""
    q0, unravel = ravel(init_position)

    def logprob_flat(q):
        return logprob_fn(unravel(q))

    if num_warmup > 0:
        q, eps, m_inv = warmup(logprob_flat, q0, generator, num_warmup, step_size,
                               max_depth, target_accept)
        eps = float(eps)  # one read here, not one a transition
    else:
        q, eps, m_inv = q0, float(step_size), torch.ones_like(q0)

    out = {"position": [], "logp": [], "accept_prob": [], "diverging": []}
    if kernel == "nuts":
        out["num_leaves"] = []
    for _ in range(int(num_samples)):
        if kernel == "nuts":
            q, logp, info = nuts_step(logprob_flat, q, generator, eps, m_inv, max_depth)
            out["num_leaves"].append(info.num_leaves)
        else:
            q, logp, info = hmc_step(logprob_flat, q, generator, eps, num_leapfrog, m_inv)
        out["position"].append(q)
        out["logp"].append(logp)
        out["accept_prob"].append(info.accept_prob)
        out["diverging"].append(info.diverging)
    positions = torch.stack(out.pop("position"))
    info = {k: torch.stack(v) if torch.is_tensor(v[0]) else torch.tensor(v) for k, v in out.items()}
    info["step_size"] = eps
    samples = torch.vmap(unravel)(positions) if isinstance(init_position, dict) else \
        positions.reshape(num_samples, *torch.as_tensor(init_position).shape)
    return samples, info


# ---------------------------------------------------------------------------
# mixture-state kernels (runner-pluggable)
# ---------------------------------------------------------------------------
def _default_transforms(state, fids, transforms):
    """POSITIVE for every scalar hyper of each listed feature, unless the
    caller says otherwise."""
    out = {}
    for fid in fids:
        spec = dict((transforms or {}).get(fid, {}))
        if not spec:
            spec = {k: POSITIVE for k, v in state.hypers[fid].items() if v.dim() == 0}
        out[fid] = spec
    return out


def hyper_logprob(state: MixtureState, priors: Dict[int, Callable],
                  transforms: Optional[Dict[int, Dict[str, tuple]]] = None):
    """The unconstrained joint target of `hp` over the selected features' hypers.

    Returns (logprob_flat, q0, unravel, transforms): logprob_flat(q) =
    sum over features of prior(hyper) + sum over active slots of
    marginal_loglik(hyper, stats) + the bijectors' log-dets, at the hypers
    unravel(q) maps to; q0 is the state's own hypers, in the state's float
    type. Empty slots are masked with `torch.where`, whose gradient there
    is zero: every conjugate likelihood's marginal is finite (0) at zero
    counts, so no NaN enters the gradient.
    """
    fids = tuple(sorted(priors))
    transforms = _default_transforms(state, fids, transforms)
    liks = state.likelihoods()
    active = state.counts > 0
    upos = {fid: {name: bij_inverse(spec, state.hypers[fid][name])
                  for name, spec in transforms[fid].items()} for fid in fids}
    q0, unravel = ravel(upos)

    def logprob_flat(q):
        u = unravel(q)
        total = torch.zeros((), dtype=q.dtype, device=q.device)
        for fid in fids:
            hyper = dict(state.hypers[fid])
            for name, spec in transforms[fid].items():
                x, ld = bij_forward(spec, u[fid][name])
                hyper[name] = x
                total = total + ld
            ml = liks[fid].marginal_loglik(hyper, state.stats[fid])
            total = total + priors[fid](hyper) + torch.where(active, ml, torch.zeros_like(ml)).sum()
        return total

    return logprob_flat, q0, unravel, transforms


def hp(state: MixtureState, data, generator, priors: Dict[int, Callable],
       transforms: Optional[Dict[int, Dict[str, tuple]]] = None,
       step_size: float = 0.05, num_steps: int = 4, max_depth: int = 6) -> MixtureState:
    """NUTS over feature hyperparameters (the config-3 kernel).

    priors: {fid: callable(hyper_dict) -> log prior}. transforms: {fid:
    {param: bijector spec}}, by default POSITIVE on every scalar hyper of
    each listed feature. Target: `hyper_logprob` (valid for conjugate
    models, whose suffstats do not depend on the hypers); num_steps NUTS
    transitions at a fixed step size.
    """
    del data
    logprob_flat, q, unravel, transforms = hyper_logprob(state, priors, transforms)
    for _ in range(int(num_steps)):
        q, _, _ = nuts_step(logprob_flat, q, generator, step_size, None, max_depth)
    u = unravel(q)
    new_hypers = list(state.hypers)
    for fid, spec in transforms.items():
        hyper = dict(state.hypers[fid])
        for name, s in spec.items():
            hyper[name] = bij_forward(s, u[fid][name])[0].to(state.hypers[fid][name].dtype)
        new_hypers[fid] = hyper
    return dataclasses.replace(state, hypers=tuple(new_hypers))


def cluster_hp(state: MixtureState, generator, prior_fn: Callable, step_size=0.1,
               num_steps: int = 4, max_depth: int = 6) -> MixtureState:
    """NUTS over the CRP concentration alpha, in log space, through the EPPF."""

    def logprob(u):
        alpha = torch.exp(u[0])
        st = dataclasses.replace(state, cluster_hp={"alpha": alpha})
        return prior_fn(alpha) + state_mod.score_assignment(st) + u[0]

    alpha0 = state.cluster_hp["alpha"]
    q = torch.log(alpha0)[None]
    for _ in range(int(num_steps)):
        q, _, _ = nuts_step(logprob, q, generator, step_size, None, max_depth)
    return dataclasses.replace(state, cluster_hp={"alpha": torch.exp(q[0]).to(alpha0.dtype)})


def theta(state: MixtureState, generator, step_size=0.1, num_steps: int = 4,
          max_depth: int = 6) -> MixtureState:
    """NUTS over explicit non-conjugate cluster latents (bbnc's p).

    The latents of all K slots are sampled jointly (given the assignments
    they are independent, so a joint NUTS is exact); bounded latents ride
    an interval bijector from the model's `latent_bounds`.
    """
    new_stats = list(state.stats)
    for f, (lik, hyper, stats_f) in enumerate(zip(state.likelihoods(), state.hypers, state.stats)):
        if lik.conjugate or not lik.latent_leaves:
            continue
        bounds = getattr(lik, "latent_bounds", {})
        specs = {name: (interval(*bounds[name]) if name in bounds else IDENTITY)
                 for name in lik.latent_leaves}
        q, unravel = ravel({name: bij_inverse(specs[name], stats_f[name]) for name in lik.latent_leaves})

        def logprob_flat(q, lik=lik, hyper=hyper, stats_f=stats_f, specs=specs, unravel=unravel):
            u = unravel(q)
            total = torch.zeros((), dtype=q.dtype, device=q.device)
            vals = {}
            for name, spec in specs.items():
                vals[name], ld = bij_forward(spec, u[name])
                total = total + ld
            lp = lik.posterior_logpdf_unnorm(hyper, stats_f, *[vals[n] for n in lik.latent_leaves])
            return total + lp.sum()

        for _ in range(int(num_steps)):
            q, _, _ = nuts_step(logprob_flat, q, generator, step_size, None, max_depth)
        u = unravel(q)
        new_stats[f] = {**stats_f, **{name: bij_forward(specs[name], u[name])[0].to(stats_f[name].dtype)
                                      for name in lik.latent_leaves}}
    return dataclasses.replace(state, stats=tuple(new_stats))
