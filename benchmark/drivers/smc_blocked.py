"""Driver `smc_blocked`: block-SMC over all rows of a DP mixture (config 5).

Set-up makes the rows and P empty particles (`smc.init_particles`), and
warms up with a pass over a prefix of the rows (the warm-up rows and
`warm_blocks` blocks) on particles of its own, so every shape a pass uses
has run. A step of the window is one pass, `kernels.smc.run_blocked` over
all rows (`warmup` rows seated one at a time, then blocks, a rejuvenation
window and a resampling check a step); the pass in flight when the window
ends finishes, and the rate counts the rows of every pass over all the
window's time. A traced run traces one pass over a prefix of the rows
instead (the warm-up rows and `trace_blocks` blocks, on particles of its
own): a whole pass launches about 1.7 million kernels, more than the
profiler's record of a run can hold within its time.

The comparison follows the program from its own state: the proposals draw
from torch's generator inside the block step, which the reference cannot
replay, and a float64 increment of every block takes longer than the
window. It judges

- the weight increment of the window's first and last block steps
  (`smc_incr_gap`, relative): the float64 increment of the block's seating
  worked out again from the proposal table the step drew, the particles'
  suffstats before the block and the block's rows under the seating;
- the evidence (`smc_logz_gap`, relative): the last pass's logz worked out
  again in float64 from every increment of the pass, warm-up rows and
  blocks, resampling where the effective sample size falls below the
  threshold;
- the last pass's particles: each particle's counts and suffstat n against
  a count of its slots (`smc_counts`, exact), and for one particle, drawn
  from the seed, the log marginal likelihood of its suffstats against that
  of a float64 restat of its rows (`smc_ml_gap`, relative).
"""

from __future__ import annotations

import math

import torch

from benchmark import data
from benchmark.drivers import _mixture as mx
from benchmark.reference import compare
from benchmark.reference import niw as ref_niw
from benchmark.reference.precision import CONTROL, REFERENCE


class Capture:
    """References to what the window produced: the first and the last block
    step's inputs and output, and the last pass's increments, resampling
    steps and result. Nothing is copied."""

    def __init__(self):
        self.first_block = self.last_block = None
        self.window = False
        self._take_first = False
        self._pass = self.last_pass = None

    def window_step(self) -> None:
        self.window = True
        self._take_first = self.first_block is None

    def pass_in(self, args, kwargs) -> None:
        self._pass = {"incr": []}

    def warm_row_out(self, args, kwargs, out) -> None:
        if self._pass is not None:
            self._pass["incr"].append(out)

    def absorb_out(self, args, kwargs, out) -> None:
        if self._pass is not None:
            self._pass["incr"].append(out[1])
        if self.window:
            self.last_block = (args, out)
            if self._take_first:
                self.first_block, self._take_first = self.last_block, False

    def pass_out(self, args, kwargs, out) -> None:
        self._pass["result"] = out
        self.last_pass, self._pass = self._pass, None


class Cell:
    def __init__(self, config, workload, seed, device, spans):
        from common_tpu_torch import state as st
        from common_tpu_torch.kernels import smc

        self.config, self.workload, self.seed, self.device = config, workload, seed, device
        n, d, K = config["n"], config["d"], config["k_max"]
        P, B, W = int(workload["particles"]), int(workload["block"]), int(workload["warmup_rows"])
        self.shape = {"n": n, "d": d, "k": K, "chains": 1, "particles": P, "block": B}
        self.x = data.rows(config, seed, device)
        desc, hyper = mx.program_model(config)
        self.smc = smc
        self.kw = dict(block=B, warmup=W, ess_threshold=float(workload["ess_threshold"]),
                       rejuvenation_blocks=int(workload["rejuvenation_blocks"]))

        def particles(rows, tag):
            cols = ((self.x[:rows], torch.ones(rows, device=device)),)
            defn = st.model_definition(rows, [desc], k_max=K)
            return smc.init_particles(defn, cols, data.generator(device, seed, tag), P,
                                      cluster_hp=dict(config["cluster_hp"]), feature_hps=[hyper]), cols

        self.parts, self.cols = particles(n, 1)
        self.warm = particles(min(n, W + int(workload["warm_blocks"]) * B), 3)
        self.traced = particles(min(n, W + int(workload["trace_blocks"]) * B), 4)
        self.gen = data.generator(device, seed, 2)
        self.log_p = math.log(P)
        self.capture = cap = Capture()
        spans.wrap(smc, "run_blocked", "smc_pass", before=cap.pass_in, after=cap.pass_out)
        spans.wrap(smc, "_warmup_row", None, after=cap.warm_row_out)
        spans.wrap(smc, "_seat_block", "seat_block")
        spans.wrap(smc, "_absorb_block", None, after=cap.absorb_out)
        spans.wrap(smc, "_rejuv_block", "rejuv_block")
        spans.wrap(smc, "_resample_step", "resample")

    # -- the window --
    def warmup(self) -> None:
        parts, cols = self.warm
        self.smc.run_blocked(parts, cols, self.gen, **self.kw)
        self.warm = None

    def step(self) -> int:
        self.capture.window_step()
        self.smc.run_blocked(self.parts, self.cols, self.gen, **self.kw)
        return self.shape["n"]

    def trace_step(self) -> int:
        parts, cols = self.traced
        self.capture.window_step()
        self.smc.run_blocked(parts, cols, self.gen, **self.kw)
        return cols[0][0].shape[0]

    def finish(self) -> None:
        del self.parts, self.traced

    # -- the comparison --
    def _incr(self, block, i: int, p) -> float:
        """Particle i's increment of one block step, worked out again in p from
        the proposal table the step drew, the suffstats before the block and
        the block's rows under the seating."""
        (pre, cols, valid, logp, loglik, z), _ = block
        x, K = cols[0][0], self.shape["k"]
        zi = z[i].to(torch.int64)
        keep = valid & (zi >= 0) & (zi < K)
        lp, ll = p(logp[i]), p(loglik[i])
        prop = torch.where(valid, torch.logsumexp(lp, -1) - ll.gather(-1, zi.clamp(0, K - 1)[:, None])[:, 0], 0.0)
        s = pre.stats[0]
        old = (s["n"][i], s["sum_x"][i], s["sum_xxT"][i])
        new = tuple(p(a) + p(b) for a, b in zip(old, ref_niw.restat(x[keep], zi[keep], K, p)))
        hyper = mx.niw_hyper(self.config, x.device)
        ml = ref_niw.marginal_loglik(hyper, *new, p) - ref_niw.marginal_loglik(hyper, *old, p)
        return float(prop.to(torch.float64).sum() + ml.to(torch.float64).sum())

    def _incr_gap(self, block, control: bool) -> float:
        """The widest relative gap over the particles of one block step's
        increment (the control's, worked in TF32) against the float64 one."""
        incr = block[1][1]
        worst = 0.0
        for i in range(self.shape["particles"]):
            got = self._incr(block, i, CONTROL) if control else float(incr[i])
            worst = max(worst, compare.rel_gap(got, self._incr(block, i, REFERENCE)))
        return worst

    def _logz(self, rec, p) -> float:
        """The pass's logz from its increments in p, resampling where the
        effective sample size falls below the threshold, as the sampler does."""
        log_w = torch.zeros_like(rec["incr"][0], dtype=p.dtype)
        logz = torch.zeros((), dtype=p.dtype, device=log_w.device)
        threshold = self.kw["ess_threshold"] * self.shape["particles"]
        for incr in rec["incr"]:
            log_w = p(p(log_w) + p(incr))
            ess = torch.exp(2.0 * torch.logsumexp(log_w, -1) - torch.logsumexp(2.0 * log_w, -1))
            if float(ess) < threshold:
                logz = p(p(logz) + p(torch.logsumexp(log_w, -1) - self.log_p))
                log_w = torch.zeros_like(log_w)
        return float(p(logz + torch.logsumexp(log_w, -1) - self.log_p))

    def _ml_gap(self, parts, i: int, control: bool) -> float:
        """Particle i's log marginal likelihood summed over its slots: its own
        suffstats (the control: a TF32 restat and posterior) against a float64
        restat of its rows, relative."""
        K, hyper = self.shape["k"], mx.niw_hyper(self.config, self.x.device)
        z = parts.assignments[i]
        ref = ref_niw.marginal_loglik(hyper, *ref_niw.restat(self.x, z, K, REFERENCE), REFERENCE).sum()
        if control:
            got = ref_niw.marginal_loglik(hyper, *ref_niw.restat(self.x, z, K, CONTROL), CONTROL).sum()
        else:
            s = parts.stats[0]
            got = ref_niw.marginal_loglik(hyper, s["n"][i], s["sum_x"][i], s["sum_xxT"][i], REFERENCE).sum()
        return compare.rel_gap(float(got), float(ref))

    def readings(self, mode: str = "program") -> dict:
        names = list(self.workload["limits"])
        cap = self.capture
        rec = cap.last_pass
        if cap.first_block is None or rec is None or "result" not in rec or not rec["incr"]:
            return {name: math.inf for name in names}
        control = mode == "control"
        parts, K = rec["result"].particles, self.shape["k"]
        i = data.derive(self.seed, 12) % self.shape["particles"]
        blocks = [cap.first_block] if cap.first_block is cap.last_block else [cap.first_block, cap.last_block]
        logz = self._logz(rec, CONTROL) if control else float(rec["result"].logz)
        out = {
            "smc_incr_gap": max(self._incr_gap(b, control) for b in blocks),
            "smc_logz_gap": compare.rel_gap(logz, self._logz(rec, REFERENCE)),
            "smc_counts": 0 if control else sum(
                mx.count_mismatch(parts.counts[j], parts.stats[0]["n"][j], parts.assignments[j], K)
                for j in range(self.shape["particles"])),
            "smc_ml_gap": self._ml_gap(parts, i, control),
        }
        return {**{name: math.inf for name in names}, **out}


def build(config, workload, seed, device, spans) -> Cell:
    return Cell(config, workload, seed, device, spans)
