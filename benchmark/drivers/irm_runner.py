"""Driver `irm_runner`: one IRM chain of blocked sweeps through `common_tpu_torch.runner`.

The relation is made on the device from the seed (`relation`: entity i of
either domain in planted group i // (N / blocks), a cell one with the
probability of its two groups' block, 0.85 on the diagonal, 0.1 off it and
0.6 in `strong_blocks` off-diagonal blocks chosen from the seed: the recipe
of `chip_smoke.py` `irm_blocks`), every cell observed. Its COO view is built
on the device in the row-major order `data.sparse_ndarray_dataview` gives.
The start is uniform over the K slots in each domain, drawn from the seed;
the runner's kernels are the workload's. Set-up runs `warmup` sweeps; a
step of the window is `runner.run(generator, chunk)`, which copies the
chunk's traces to the host as users' runs do.

The comparison (`benchmark/reference/irm.py`) judges what the window's first
and last sweeps produced (`Capture`), each stage from the program's own
inputs:

- `stick_counts`: the counts handed to each domain's stick draw against a
  recount of the sweep's starting z (exact); `weights_sum`: each domain's
  log w a log-simplex;
- `theta_t`: the captured eta against Beta(a + h, b + n - h) of a recount
  of the starting z;
- `table_gap`: each domain's [N_d, K] table against the float64 one from the
  captured eta and the model's other z (the row table from the starting
  column z, the column table from the new row z), the largest relative
  difference;
- `assign_fit_t`: each domain's drawn z against softmax(log w + the float64
  table);
- `irm_counts`: the final counts and (n, heads) against an int64 recount of
  the final z over the relation (exact);
- `score_gap`: the joint score the runner traced for the window's last
  sweep against the float64 score of the final z, relative.

`mode="control"` puts the reference in the program's place in bfloat16: its
own eta and stick weights drawn in bfloat16 from the recounts, the tables
from the captured eta in bfloat16 and its own z drawn from them, the joint
score in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import data
from benchmark.drivers import _mixture as mx
from benchmark.reference import compare, sticks
from benchmark.reference import irm as ref
from benchmark.reference.precision import REFERENCE


def relation(config: dict, seed: int, device) -> torch.Tensor:
    """[N0, N1] float32 zeros and ones of the configuration on `device`."""
    spec = config["data"]
    n0, n1 = config["domains"]
    B = spec["blocks"]
    g = data.generator(device, seed, 0)
    eta = torch.full((B, B), spec["off_diagonal"], device=device)
    eta.fill_diagonal_(spec["diagonal"])
    off = (~torch.eye(B, dtype=torch.bool, device=device)).nonzero()
    pick = off[torch.randperm(off.shape[0], generator=g, device=device)[:spec["strong_blocks"]]]
    eta[pick[:, 0], pick[:, 1]] = spec["strong"]
    g0 = torch.arange(n0, device=device) // (n0 // B)
    g1 = torch.arange(n1, device=device) // (n1 // B)
    return (torch.rand((n0, n1), generator=g, device=device) < eta[g0][:, g1]).to(torch.float32)


def dense_view(x: torch.Tensor):
    """The COO view of a fully observed relation, on its device: every cell in row-major order."""
    from common_tpu_torch import relational

    n0, n1 = x.shape
    i = torch.arange(n0, device=x.device).repeat_interleave(n1)
    j = torch.arange(n1, device=x.device).repeat(n0)
    return relational.RelView(torch.stack([i, j], 1), x.reshape(-1), torch.ones(n0 * n1, device=x.device))


class Capture(mx.FirstLast):
    """References to what the window's first and last sweeps produced: the
    state before the sweep, eta, each domain's stick counts and log w and
    its table (in the order drawn), and the state after the restat. Nothing
    is copied."""

    def sweep_in(self, args, kwargs) -> None:
        self._cur = {"pre": args[0], "weights": [], "tables": []}

    def theta_out(self, args, kwargs, out) -> None:
        if self._cur is not None and "theta" not in self._cur:
            self._cur["theta"] = out[0]["p"]

    def weights_out(self, args, kwargs, out) -> None:
        if self._cur is not None:
            self._cur["weights"].append((args[1], out))

    def table_out(self, args, kwargs, out) -> None:
        if self._cur is not None:
            self._cur["tables"].append((args[3], out))

    def sweep_out(self, args, kwargs, out) -> None:
        if self._cur is not None:
            self._cur["post"] = out
            self._close()

    def sweeps(self):
        recs = self.records()
        if recs is None or any("theta" not in r or "post" not in r or len(r["weights"]) != 2
                               or [d for d, _ in r["tables"]] != [0, 1] for r in recs):
            return None
        return recs


class Cell:
    def __init__(self, config, workload, seed, device, spans):
        from common_tpu_torch import models
        from common_tpu_torch import relational as irm
        from common_tpu_torch import runner as runner_mod
        from common_tpu_torch.relational import kernels as irm_kernels

        from benchmark.drivers.mixture_runner import kernel_config

        self.config, self.workload, self.seed = config, workload, seed
        n0, n1 = config["domains"]
        K = config["k_max"]
        self.x = relation(config, seed, device)
        self.mask = torch.ones_like(self.x, dtype=torch.bool)
        self.shape = {"n0": n0, "n1": n1, "k": K, "cells": n0 * n1}
        views = irm.as_views([dense_view(self.x)])
        defn = irm.model_definition([n0, n1], [((0, 1), models.bb)], k_max=K)
        r = np.random.default_rng(data.derive(seed, 1))
        start = [r.integers(0, K, n).astype(np.int32) for n in (n0, n1)]
        alpha = config["crp_alpha"]
        s0 = irm.initialize(defn, views, data.generator(device, seed, 2), cluster_hps=[{"alpha": alpha}] * 2,
                            relation_hps=[dict(config["hyper"])], domain_assignments=start)
        self.runner = runner_mod.runner(defn, views, s0, kernel_config(workload["kernels"]))
        self.gen = data.generator(device, seed, 3)
        self.chunk = int(workload["chunk"])
        self.capture = cap = Capture()
        spans.wrap(runner_mod.IRM_KERNELS, "assign_blocked", "sweep", before=cap.sweep_in, after=cap.sweep_out)
        spans.wrap(irm_kernels, "_sample_block_params", None, after=cap.theta_out)
        spans.wrap(irm_kernels, "stick_break_log_weights", None, after=cap.weights_out)
        spans.wrap(irm_kernels, "_domain_loglik_table", "irm_table", after=cap.table_out)
        spans.wrap(irm_kernels, "restat", "irm_restat")

    # -- the window --
    def warmup(self) -> None:
        self.runner.run(self.gen, int(self.workload["warmup"]))

    def step(self) -> int:
        self.capture.window_step()  # the window's first sweep is judged with its last
        self.runner.run(self.gen, self.chunk)
        return self.chunk

    def finish(self) -> None:
        self.final = self.runner.get_latent()
        self.score = float(self.runner.score_trace[-1])
        del self.runner

    # -- the comparison --
    def _sweep_readings(self, rec, control: bool, gen) -> dict:
        """The readings of one judged sweep (gen(tag): the control's and the fit's generators)."""
        K, h = self.shape["k"], self.config["hyper"]
        pre, post = rec["pre"], rec["post"]
        out = {"stick_counts": 0, "weights_sum": 0.0, "table_gap": 0.0, "assign_fit_t": 0.0}
        n, heads = ref.block_counts(pre.assignments[0], pre.assignments[1], self.x, self.mask, K, K)
        A, B = ref.theta_params(n, heads, h["alpha"], h["beta"])
        theta = ref.beta_draw(A, B, gen(20), ref.CONTROL) if control else rec["theta"]
        out["theta_t"] = ref.beta_fit_t(theta, A, B)
        others = (pre.assignments[1], post.assignments[0])  # the row table's column z, the column table's row z
        for d, ((counts_in, logw), (_, tab)) in enumerate(zip(rec["weights"], rec["tables"])):
            counts = ref.assignment_counts(pre.assignments[d], K)
            if control:
                logw = sticks.draw(counts, self.config["crp_alpha"], gen(30 + d), ref.CONTROL)
            else:
                out["stick_counts"] += int((counts_in.to(torch.int64) != counts).sum())
            out["weights_sum"] = max(out["weights_sum"], abs(float(torch.logsumexp(logw.to(torch.float64), -1))))
            want = ref.table(others[d], self.x, self.mask, rec["theta"], d, REFERENCE)
            if control:
                tab = ref.table(others[d], self.x, self.mask, rec["theta"], d, ref.CONTROL)
            gap = (tab.to(torch.float64) - want).abs() / want.abs().clamp(min=1e-300)
            out["table_gap"] = max(out["table_gap"], float(gap.max()))
            logits = logw.to(torch.float64)[None, :] + want
            if control:
                z = ref.assign_draw(ref.CONTROL(ref.CONTROL(logw)[None, :] + tab), gen(40 + d))
            else:
                z = post.assignments[d]
            out["assign_fit_t"] = max(out["assign_fit_t"], ref.assign_fit_t(logits, z, gen(60 + d)))
        return out

    def _count_gap(self, final) -> int:
        """Entries of the final counts and (n, heads) that differ from a recount of the final z."""
        K = self.shape["k"]
        z0, z1 = final.assignments
        n, heads = ref.block_counts(z0, z1, self.x, self.mask, K, K)
        bad = sum(int((c.to(torch.int64) != ref.assignment_counts(z, K)).sum())
                  for c, z in zip(final.counts, final.assignments))
        stats = final.suffstats[0]
        return bad + int((stats["n"].to(torch.float64) != n.to(torch.float64)).sum()
                         + (stats["heads"].to(torch.float64) != heads.to(torch.float64)).sum())

    def readings(self, mode: str = "program") -> dict:
        names = list(self.workload["limits"])
        sweeps = self.capture.sweeps()
        if sweeps is None:
            return {name: math.inf for name in names}
        control = mode == "control"
        dev = self.x.device
        out = {"irm_counts": 0 if control else self._count_gap(self.final)}
        for i, rec in enumerate(sweeps):
            got = self._sweep_readings(rec, control, lambda tag, i=i: data.generator(dev, self.seed, tag, i))
            for name, value in got.items():
                out[name] = max(out.get(name, 0), value)
        K, h = self.shape["k"], self.config["hyper"]
        z0, z1 = self.final.assignments
        alphas = [self.config["crp_alpha"]] * 2

        def score(p):
            return ref.score_joint(z0, z1, self.x, self.mask, K, K, h["alpha"], h["beta"], alphas, p)

        out["score_gap"] = compare.rel_gap(score(ref.CONTROL) if control else self.score, score(REFERENCE))
        return {**{name: math.inf for name in names}, **out}


def build(config, workload, seed, device, spans) -> Cell:
    return Cell(config, workload, seed, device, spans)
