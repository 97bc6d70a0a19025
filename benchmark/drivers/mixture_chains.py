"""Driver `mixture_chains`: C DP-mixture chains on one dataset, swept together.

Path A of the program: `parallel.stack_states` of C initialised states,
then `kernels.blocked.sweep_chains(states, data, generator, fused=True)`
(the multi-chain assignment kernel) `chunk` times a step, each chain's
joint score traced a sweep (for split-R-hat, as users run it) and copied to
the host at the end of each step. The rate counts chain-sweeps. The
comparison (`_mixture`) judges each row's slot in every chain in the
window's first and last sweeps, the stick weights and theta behind them,
and after the last the chains' counts and each chain's traced joint score.
"""

from __future__ import annotations

import math

import torch

from benchmark import data
from benchmark.drivers import _mixture as mx
from benchmark.reference import compare
from benchmark.reference.precision import CONTROL, REFERENCE


class Cell:
    def __init__(self, config, workload, seed, device, spans):
        from common_tpu_torch import state as st
        from common_tpu_torch.kernels import blocked
        from common_tpu_torch.parallel import stack_states, unstack_state

        self.config, self.workload, self.seed, self.device = config, workload, seed, device
        n, d, K, C = config["n"], config["d"], config["k_max"], int(workload["chains"])
        self.shape = {"n": n, "d": d, "k": K, "chains": C}
        self.x = data.rows(config, seed, device)
        desc, hyper = mx.program_model(config)
        defn = st.model_definition(n, [desc], k_max=K)
        self.cols = ((self.x, torch.ones(n, device=device)),)
        g = data.generator(device, seed, 1)
        self.states = stack_states([st.initialize(defn, self.cols, g, cluster_hp=dict(config["cluster_hp"]),
                                                  feature_hps=[hyper]) for _ in range(C)])
        self.gen = data.generator(device, seed, 2)
        self.chunk = int(workload["chunk"])
        self.blocked, self.score_joint, self.unstack = blocked, st.score_joint, unstack_state
        self.score_trace = []  # [C] per sweep, on the host
        self.capture = cap = mx.Capture()
        spans.wrap(blocked, "sweep_chains", "sweep", before=cap.sweep_in, after=cap.sweep_out)
        spans.wrap(blocked, "stick_break_log_weights", None, after=cap.weights_out)
        spans.wrap(blocked, "fused_gaussian_assign_chains", "assign_chains", after=cap.assign_out)
        spans.wrap(blocked, "fused_scatter_stats", "suffstat")

    def _sweeps(self, count: int) -> None:
        """`count` sweeps of all chains, each chain's joint score traced a sweep
        (for split-R-hat); the chunk's trace is copied to the host at its end."""
        C, trace = self.shape["chains"], []
        for _ in range(count):
            self.states = self.blocked.sweep_chains(self.states, self.cols, self.gen, fused=True)
            trace.append(torch.stack([self.score_joint(self.unstack(self.states, c)) for c in range(C)]))
        self.score_trace.extend(torch.stack(trace).cpu().tolist())

    def warmup(self) -> None:
        self._sweeps(int(self.workload["warmup"]))

    def step(self) -> int:
        self.capture.window_step()  # the window's first sweep is judged with its last
        self._sweeps(self.chunk)
        return self.chunk * self.shape["chains"]

    def finish(self) -> None:
        del self.states

    def _assign_gap(self, sweep, control: bool) -> float:
        X, n, K, C = self.x, self.shape["n"], self.shape["k"], self.shape["chains"]
        args, z = sweep["assign"]
        _, mu, B, base, seed = args[:5]
        noise = mx.Noise("gaussian", int(seed.reshape(())), n, K, C, X.device)
        if control:
            z = compare.argmax_draw(mx.gaussian_scores_fn(X, mu, B, base, CONTROL, C), noise, n, mx.ROWS)
        else:
            z = z.T
        return compare.widest_gap(mx.gaussian_scores_fn(X, mu, B, base, REFERENCE, C), noise, z, n, mx.ROWS)

    def readings(self, mode: str = "program") -> dict:
        names = list(self.workload["limits"])
        sweeps = self.capture.sweeps()
        if sweeps is None:
            return {name: math.inf for name in names}
        control = mode == "control"
        X, K, C, last = self.x, self.shape["k"], self.shape["chains"], sweeps[-1]
        hyper = mx.niw_hyper(self.config, X.device)
        args = last["assign"][0]
        gen = data.generator(X.device, self.seed, 9) if control else None
        t_mean, t_cov = mx.theta_readings(X, last["pre"].assignments, hyper, args[1], args[2],
                                          CONTROL if control else None, gen, chains=C)
        post = last["post"]
        score_gap = 0.0
        for c in range(C):
            zc, alpha = post.assignments[c], post.cluster_hp["alpha"][c].to(torch.float64)
            reference = mx.niw_score(X, zc, K, hyper, alpha, REFERENCE)
            score = mx.niw_score(X, zc, K, hyper, alpha, CONTROL) if control else self.score_trace[-1][c]
            score_gap = max(score_gap, compare.rel_gap(score, reference))
        out = {
            "assign_gap": max(self._assign_gap(s, control) for s in sweeps),
            "state_rows": 0 if control else sum(int((s["post"].assignments != s["assign"][1]).sum())
                                                for s in sweeps),
            "restat_n": 0 if control else mx.count_mismatch(post.counts, post.stats[0]["n"],
                                                             post.assignments, K),
            "score_gap": score_gap,
            "theta_mean_t": t_mean,
            "theta_cov_t": t_cov,
            **mx.weights_readings(sweeps, 3, mx.niw_extra, K, C, control,
                                  data.generator(X.device, self.seed, 10) if control else None),
        }
        return {**{name: math.inf for name in names}, **out}


def build(config, workload, seed, device, spans) -> Cell:
    return Cell(config, workload, seed, device, spans)
