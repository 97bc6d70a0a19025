"""What the DP-mixture drivers share: the model, what the window produced, the comparison.

The comparison follows the program step by step from its own state:

- the assignment, in the window's first and last sweeps (`Capture`): the
  float64 scores of the kernel's own inputs plus its own noise, worked out
  again from its seed, at the slot each row got (`assign_gap`), and the
  state's slots against the kernel's (`state_rows`);
- the restat: the state's counts against a count of its slots (`restat_n`,
  exact; bbv's heads too);
- the joint score the program traced for the final state (`score_gap`),
  against the float64 score of the final slots, hypers and concentration;
- the theta draw (`theta_mean_t`, `theta_cov_t`, each ~ |N(0, 1)| for an
  exact draw): the kernel's mu and B (Sigma^-1 = B^T B) against the float64
  NIW posterior of the slots the sweep started from;
- the stick weights behind the kernel's `base` (`weights_readings`): the
  counts they were drawn from against a count of the slots the sweep
  started from (`stick_counts`), base against log w plus the model's own
  term worked out again (`base_gap`), and log w a log-simplex
  (`weights_sum`); each stick against its Beta posterior (`stick_z`) is
  printed, not compared.

`mode="control"` puts the reference in TF32 in the program's place at each
stage and judges what it produces the same way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import bbv as ref_bbv
from benchmark.reference import philox
from benchmark.reference import niw as ref_niw
from benchmark.reference import sticks
from benchmark.reference.precision import CONTROL, REFERENCE

ROWS = 65536  # rows of a block in the reference


def niw_hyper(config: dict, device) -> dict:
    """The configuration's NIW prior as float64 tensors (mu0 and psi spelled
    as a scalar times the zero vector / the identity)."""
    h, d = config["hyper"], config["d"]
    return {"mu0": torch.full((d,), float(h["mu0"]), dtype=torch.float64, device=device),
            "kappa": torch.tensor(float(h["kappa"]), dtype=torch.float64, device=device),
            "psi": float(h["psi"]) * torch.eye(d, dtype=torch.float64, device=device),
            "nu": torch.tensor(float(h["nu"]), dtype=torch.float64, device=device)}


def program_model(config: dict):
    """(descriptor, feature hypers) of the configuration for the program."""
    from common_tpu_torch import models

    d, h = config["d"], config["hyper"]
    if config["model"] == "niw":
        return models.niw(d), {"mu0": np.full(d, h["mu0"], np.float32), "kappa": float(h["kappa"]),
                               "psi": float(h["psi"]) * np.eye(d, dtype=np.float32), "nu": float(h["nu"])}
    if config["model"] == "bbv":
        return models.bbv(d), {"alpha": np.full(d, h["alpha"], np.float32),
                               "beta": np.full(d, h["beta"], np.float32)}
    raise ValueError(f"unknown model {config['model']!r}")


class FirstLast:
    """What the window's first and last calls of one entry produced: a driver
    calls `window_step()` before each step of the window; a hook opens a
    record (`_cur`) as the call starts and `_close()` keeps it as it ends."""

    def __init__(self):
        self.first = self.last = self._cur = None
        self._take_first = False

    def window_step(self) -> None:
        self._take_first = self.first is None

    def _close(self) -> None:
        self.last, self._cur = self._cur, None
        if self._take_first:
            self.first, self._take_first = self.last, False

    def records(self):
        """[first], or [first, last] where they differ; None before the window."""
        if self.first is None or self.last is None:
            return None
        return [self.first] if self.first is self.last else [self.first, self.last]


class Capture(FirstLast):
    """References to what the window's first and last sweeps produced: the
    state before and after, the stick weights drawn (with the counts and
    concentration they were drawn from, a chain each), and the assignment
    kernel's inputs and draw. Nothing is copied. A driver wraps the sweep,
    the stick-breaking draw and the kernel with the hooks below."""

    def sweep_in(self, args, kwargs) -> None:
        self._cur = {"pre": args[0], "assign": None, "weights": []}

    def weights_out(self, args, kwargs, out) -> None:
        if self._cur is not None:
            self._cur["weights"].append((args[1], args[2], out))

    def assign_out(self, args, kwargs, out) -> None:
        if self._cur is not None:
            self._cur["assign"] = (args, out)

    def sweep_out(self, args, kwargs, out) -> None:
        self._cur["post"] = out
        self._close()

    def sweeps(self):
        """The judged sweeps (first, then last unless they are one), or None
        when a sweep of the window ran no kernel or none was seen."""
        sweeps = self.records()
        if sweeps is None or any(s.get("assign") is None or s.get("post") is None for s in sweeps):
            return None
        return sweeps


class Noise:
    """The assignment kernel's noise for rows lo..hi-1, worked out again from its seed.

    On the card: Philox (`reference/philox.py`). On the CPU the program's
    plain versions draw from a CPU generator seeded with the kernel seed
    over the whole table, which is drawn once here.
    """

    def __init__(self, kind: str, seed: int, n: int, k: int, chains: int, device):
        self.kind, self.seed, self.n, self.k, self.chains = kind, seed, n, k, chains
        self.device = torch.device(device)
        self._table = None
        if self.device.type == "cpu":
            shape = (n, k) if chains == 1 else (n, chains, k)
            self._table = philox.gumbel_of_uniform(philox.cpu_uniforms(seed, shape))

    def __call__(self, lo: int, hi: int) -> torch.Tensor:
        if self._table is not None:
            return self._table[lo:hi]
        rows = torch.arange(lo, hi, device=self.device)
        if self.kind == "linear":
            return philox.linear_noise(self.seed, rows, self.k)
        if self.chains == 1:
            return philox.gaussian_noise(self.seed, rows, self.k)
        return torch.stack([philox.gaussian_noise(self.seed, rows, self.k, c) for c in range(self.chains)], 1)


def gaussian_scores_fn(X, mu, B, base, p, chains: int = 1):
    """scores(lo, hi) of the Gaussian assignment's inputs in precision p:
    [rows, K], or [rows, C, K] for C chains (slot c K + k)."""
    K = mu.shape[0] // chains

    def scores(lo, hi):
        s = ref_niw.scores(X[lo:hi], mu, B, base, p)
        return s if chains == 1 else s.reshape(hi - lo, chains, K)

    return scores


def theta_readings(X, pre_z, hyper, mu, B, p_draw=None, generator=None, chains: int = 1):
    """(|t_mean|, |t_cov|) of the draw (mu, B) against the float64 posterior of
    the rows under pre_z ([N] or [C, N]); with p_draw the control draws its
    own theta in that precision from its own restat instead."""
    z = pre_z.reshape(chains, -1)
    K = mu.shape[0] // chains
    posts, draws = [], []
    for c in range(chains):
        post = ref_niw.posterior(hyper, *ref_niw.restat(X, z[c], K, REFERENCE), REFERENCE)
        posts.append(post)
        if p_draw is not None:
            post_c = ref_niw.posterior(hyper, *ref_niw.restat(X, z[c], K, p_draw), p_draw)
            draws.append(ref_niw.draw(post_c, generator, p_draw))
            if draws[-1] is None:
                return math.inf, math.inf  # the control gave no draw
    post = {k: torch.cat([q[k] for q in posts]) for k in posts[0]}
    if p_draw is not None:
        mu = torch.cat([m for m, _ in draws])
        B = torch.cat([b for _, b in draws])
    t_mean, t_cov = ref_niw.theta_stats(mu, B, post)
    return abs(t_mean), abs(t_cov)


def niw_score(X, z, K, hyper, alpha, p):
    """log p(partition, rows) of slots z under the CRP and the NIW prior, in p."""
    n, sum_x, sum_xxT = ref_niw.restat(X, z, K, p)
    ml = ref_niw.marginal_loglik(hyper, n, sum_x, sum_xxT, p)
    return float(ref_bbv.crp_log_prob(n, alpha, p) + ml.sum())


def bbv_score(X, z, K, alpha_hyp, beta_hyp, alpha, p):
    n, heads = ref_bbv.restat(X, z, K, REFERENCE)
    ml = ref_bbv.marginal_loglik(alpha_hyp, beta_hyp, n, heads, p)
    return float(ref_bbv.crp_log_prob(n, alpha, p) + ml.sum())


def count_mismatch(state_counts, stats_n, z, K, heads=None, X=None) -> int:
    """Slots whose counts (and n, and bbv's heads) differ from a count of z."""
    zl = z.to(torch.int64)
    zl = zl.reshape(-1, zl.shape[-1])
    n_ref = torch.stack([torch.bincount(r[(r >= 0) & (r < K)], minlength=K) for r in zl]).reshape(-1)
    bad = int((state_counts.reshape(-1).to(torch.int64) != n_ref).sum())
    bad += int((stats_n.reshape(-1).to(torch.float64) != n_ref.to(torch.float64)).sum())
    if heads is not None:
        _, h_ref = ref_bbv.restat(X, z, K, REFERENCE)
        bad += int((heads.to(torch.float64) != h_ref).sum())
    return bad


def weights_readings(sweeps, base_arg: int, extra, K: int, chains: int, control: bool,
                     generator) -> dict:
    """The stick weights behind the kernel's `base` (its argument `base_arg`)
    in the judged sweeps.

    extra(sweep, p) gives [C * K] the model's part of base beside log w,
    worked out again from the kernel's inputs in precision p (niw: log|det
    B| - D/2 log 2 pi; bbv: the sum of log(1 - p) over the columns). The
    control draws its own weights in TF32 from the same counts and composes
    base from the program's log w in TF32.
    """
    out = {"stick_counts": 0, "base_gap": 0.0, "weights_sum": 0.0, "stick_z": 0.0}
    for s in sweeps:
        if len(s["weights"]) != chains:
            return {name: math.inf for name in out}
        pre = s["pre"]
        z = pre.assignments.reshape(chains, -1).to(torch.int64)
        alphas = pre.cluster_hp["alpha"].reshape(-1).to(torch.float64)
        logw = torch.stack([w.reshape(-1).to(torch.float64) for _, _, w in s["weights"]])  # [C, K]
        base = s["assign"][0][base_arg]
        for c, (counts_in, _, _) in enumerate(s["weights"]):
            ref = torch.bincount(z[c][(z[c] >= 0) & (z[c] < K)], minlength=K)[:K]
            if not control:
                out["stick_counts"] += int((counts_in.reshape(-1).to(torch.int64) != ref).sum())
            drawn = sticks.draw(ref, alphas[c], generator, CONTROL).to(torch.float64) if control else logw[c]
            out["weights_sum"] = max(out["weights_sum"], abs(float(torch.logsumexp(drawn, -1))))
            zs = sticks.stick_z(drawn, ref, alphas[c])[ref[:-1] > 0]
            out["stick_z"] = max(out["stick_z"], float(zs.abs().max()) if zs.numel() else 0.0)
        want = logw.reshape(-1) + extra(s, REFERENCE)
        got = (CONTROL(CONTROL(logw.reshape(-1)) + CONTROL(extra(s, CONTROL))).to(torch.float64)
               if control else base.reshape(-1).to(torch.float64))
        out["base_gap"] = max(out["base_gap"], float((got - want).abs().max()))
    return out


def niw_extra(sweep, p) -> torch.Tensor:
    """[C * K] log|det B_k| - D/2 log 2 pi of the Gaussian kernel's B, in p."""
    B = sweep["assign"][0][2]
    half_log2pi = 0.5 * B.shape[-1] * math.log(2.0 * math.pi)
    if p is REFERENCE:
        return torch.linalg.slogdet(B.to(torch.float64))[1] - half_log2pi
    return (p(torch.linalg.slogdet(p(B))[1]) - p(half_log2pi)).to(torch.float64)


def bbv_extra(sweep, p) -> torch.Tensor:
    """[K] sum_d log(1 - p_kd) of the linear kernel's W = logit p, in p."""
    W = sweep["assign"][0][1]
    if p is REFERENCE:
        return -torch.nn.functional.softplus(W.to(torch.float64)).sum(-1)
    return p(p(-torch.nn.functional.softplus(p(W))).sum(-1)).to(torch.float64)
