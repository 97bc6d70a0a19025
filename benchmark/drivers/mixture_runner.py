"""Driver `mixture_runner`: one DP-mixture chain through `common_tpu_torch.runner`.

The workload's `kernels` is the runner's kernel config as users write it,
in JSON: a prior is `[name, *args]` of `common_tpu_torch.scalar_functions`,
bounds a pair, a feature index a string. Set-up makes the rows, the CRP
start and the runner, and runs `warmup` iterations; a step of the window
is `runner.run(generator, chunk)` (which copies the chunk's traces to the
host, as users' runs do). The comparison (`_mixture`) judges the draws of
the window's first and last sweeps, the stick weights and theta behind
them, the final counts and the runner's last joint score. With a
`slice_hp` kernel it also judges the hyper moves of the window's first and
last iterations (`SliceCapture`): every coordinate the sampler was given
moves (`slice_unmoved`), each new value lies on the slice its update drew,
by the float64 target (`slice_level_gap`), and the final hypers lie within
the sampler's bounds (`hp_bounds`).
"""

from __future__ import annotations

import math

import torch

from benchmark import data
from benchmark.drivers import _mixture as mx
from benchmark.reference import bbv as ref_bbv
from benchmark.reference import compare
from benchmark.reference import slice as ref_slice
from benchmark.reference.precision import CONTROL, REFERENCE


def log_prior(spec):
    """The reference's log density of a prior named as in the workload: [name, *args]."""
    name, *args = spec
    if name == "log_exponential":
        (rate,) = args
        return lambda x: math.log(rate) - rate * x
    raise ValueError(f"no reference for the prior {name!r}")


def _decode(value, key=None):
    from common_tpu_torch import scalar_functions

    if key == "prior":
        name, *args = value
        return getattr(scalar_functions, name)(*args)
    if key == "bounds":
        return tuple(float(v) for v in value)
    if isinstance(value, dict):
        return {(int(k) if k.isdigit() else k): _decode(v, k) for k, v in value.items()}
    return value


def kernel_config(kernels) -> list:
    return [(name, _decode(kw)) for name, kw in kernels]


class SliceCapture(mx.FirstLast):
    """References to what the window's first and last `slice_hp` calls
    produced: the state before and after, and each slice update's level
    uniform (the first uniform it draws), in call order. Nothing is copied."""

    def hp_in(self, args, kwargs) -> None:
        self._cur = {"pre": args[0], "levels": [], "waiting": False}

    def update_in(self, args, kwargs) -> None:
        if self._cur is not None:
            self._cur["waiting"] = True

    def uniform_out(self, args, kwargs, out) -> None:
        if self._cur is not None and self._cur["waiting"]:
            self._cur["levels"].append(out)
            self._cur["waiting"] = False

    def hp_out(self, args, kwargs, out) -> None:
        self._cur["post"] = out
        self._close()


class Cell:
    def __init__(self, config, workload, seed, device, spans):
        from common_tpu_torch import runner as runner_mod
        from common_tpu_torch import state as st
        from common_tpu_torch.kernels import blocked, slice_

        self.config, self.workload, self.seed, self.device = config, workload, seed, device
        n, d, K = config["n"], config["d"], config["k_max"]
        self.shape = {"n": n, "d": d, "k": K, "chains": 1}
        self.x = data.rows(config, seed, device)
        desc, hyper = mx.program_model(config)
        defn = st.model_definition(n, [desc], k_max=K)
        cols = ((self.x, torch.ones(n, device=device)),)
        s0 = st.initialize(defn, cols, data.generator(device, seed, 1),
                           cluster_hp=dict(config["cluster_hp"]), feature_hps=[hyper])
        self.kernels = kernel_config(workload["kernels"])
        self.runner = runner_mod.runner(defn, cols, s0, self.kernels)
        self.gen = data.generator(device, seed, 2)
        self.chunk = int(workload["chunk"])
        self.capture = cap = mx.Capture()
        spans.wrap(runner_mod.KERNELS, "assign_blocked_fused", "sweep",
                   before=cap.sweep_in, after=cap.sweep_out)
        spans.wrap(blocked, "stick_break_log_weights", None, after=cap.weights_out)
        spans.wrap(blocked, "fused_gaussian_assign", "assign", after=cap.assign_out)
        spans.wrap(blocked, "fused_linear_assign", "assign_linear", after=cap.assign_out)
        spans.wrap(blocked, "fused_scatter_stats", "suffstat")
        self.slice_capture = None
        if any(name == "slice_hp" for name, _ in self.kernels):
            self.slice_capture = sc = SliceCapture()
            spans.wrap(runner_mod.KERNELS, "slice_hp", "slice_hp", before=sc.hp_in, after=sc.hp_out)
            spans.wrap(slice_, "slice_sample", None, before=sc.update_in)
            spans.wrap(slice_, "uniform_open", None, after=sc.uniform_out)

    # -- the window --
    def warmup(self) -> None:
        self.runner.run(self.gen, int(self.workload["warmup"]))

    def step(self) -> int:
        self.capture.window_step()  # the window's first sweep is judged with its last
        if self.slice_capture is not None:
            self.slice_capture.window_step()
        self.runner.run(self.gen, self.chunk)
        return self.chunk

    def finish(self) -> None:
        self.final = self.runner.get_latent()
        trace = self.runner.score_trace
        self.score = float(trace[-1]) if len(trace) else math.nan
        del self.runner

    # -- the comparison --
    def _assign_gap(self, sweep, control: bool) -> float:
        """The widest gap of one sweep's draw (the control's own draw from the
        same inputs and noise with control)."""
        X, n, K = self.x, self.shape["n"], self.shape["k"]
        args, z = sweep["assign"]
        if self.config["model"] == "niw":
            _, mu, B, base, seed = args[:5]
            noise = mx.Noise("gaussian", int(seed.reshape(())), n, K, 1, X.device)
            ref = mx.gaussian_scores_fn(X, mu, B, base, REFERENCE)
            ctrl = mx.gaussian_scores_fn(X, mu, B, base, CONTROL)
        else:
            _, W, base, seed = args[:4]
            noise = mx.Noise("linear", int(seed.reshape(())), n, K, 1, X.device)

            def ref(lo, hi):
                return ref_bbv.linear_scores(X[lo:hi], W, base, REFERENCE)

            def ctrl(lo, hi):
                return ref_bbv.linear_scores(X[lo:hi], W, base, CONTROL)

        if control:
            z = compare.argmax_draw(ctrl, noise, n, mx.ROWS)
        return compare.widest_gap(ref, noise, z, n, mx.ROWS)

    def readings(self, mode: str = "program") -> dict:
        names = list(self.workload["limits"])
        sweeps = self.capture.sweeps()
        if sweeps is None:
            return {name: math.inf for name in names}
        control = mode == "control"
        X, K, last, final = self.x, self.shape["k"], sweeps[-1], self.final
        alpha = final.cluster_hp["alpha"].to(torch.float64)
        out = {"assign_gap": max(self._assign_gap(s, control) for s in sweeps),
               "state_rows": 0 if control else sum(int((s["post"].assignments != s["assign"][1]).sum())
                                                   for s in sweeps)}
        stick_gen = data.generator(X.device, self.seed, 10) if control else None
        if self.config["model"] == "niw":
            args = last["assign"][0]
            hyper = mx.niw_hyper(self.config, X.device)
            gen = data.generator(X.device, self.seed, 9) if control else None
            out["theta_mean_t"], out["theta_cov_t"] = mx.theta_readings(
                X, last["pre"].assignments, hyper, args[1], args[2], CONTROL if control else None, gen)
            out.update(mx.weights_readings(sweeps, 3, mx.niw_extra, K, 1, control, stick_gen))
            reference = mx.niw_score(X, final.assignments, K, hyper, alpha, REFERENCE)
            score = mx.niw_score(X, final.assignments, K, hyper, alpha, CONTROL) if control else self.score
            heads = None
        else:
            h = final.hypers[0]
            reference = mx.bbv_score(X, final.assignments, K, h["alpha"], h["beta"], alpha, REFERENCE)
            score = (mx.bbv_score(X, final.assignments, K, h["alpha"], h["beta"], alpha, CONTROL)
                     if control else self.score)
            heads = final.stats[0]["heads"]
            out.update(mx.weights_readings(sweeps, 2, mx.bbv_extra, K, 1, control, stick_gen))
            if self.slice_capture is not None:
                out["hp_bounds"] = 0 if control else self._out_of_bounds(final)
                out.update(self._slice_readings(control))
        out["restat_n"] = 0 if control else mx.count_mismatch(
            final.counts, final.stats[0]["n"], final.assignments, K, heads, X)
        out["score_gap"] = compare.rel_gap(score, reference)
        return {**{name: math.inf for name in names}, **out}

    def _hyper_scan(self):
        """The slice updates in the sampler's order: (feature, parameter, spec)
        of each feature's parameters by sorted name, then the concentration."""
        kw = dict(self.workload["kernels"])["slice_hp"]
        scan = [(int(fid), name, spec) for fid, params in sorted(kw.get("specs", {}).items(), key=lambda i: int(i[0]))
                for name, spec in sorted(params.items())]
        if "cluster" in kw:
            scan.append((None, "alpha", kw["cluster"]))
        return scan

    def _slice_readings(self, control: bool) -> dict:
        """slice_unmoved and slice_level_gap of the judged slice_hp calls: the
        program's moves, or the control's (its own slice sampler, its target in
        TF32, from the same states), each judged by the float64 target of the
        rows under the state's slots."""
        calls = self.slice_capture.records()
        if calls is None or any("post" not in c for c in calls):
            return {"slice_unmoved": math.inf, "slice_level_gap": math.inf}
        X, K, cpu = self.x, self.shape["k"], torch.device("cpu")
        rng = torch.Generator().manual_seed(data.derive(self.seed, 11))

        def uniform():
            return float(torch.rand((), generator=rng, dtype=torch.float64))

        unmoved, widest = 0, -math.inf
        for call in calls:
            pre, post = call["pre"], call["post"]
            n, heads = (t.to(cpu) for t in ref_bbv.restat(X, pre.assignments, K, REFERENCE))
            hypers = {name: v.to(cpu, torch.float64) for name, v in pre.hypers[0].items()}
            levels = iter(torch.log(torch.stack([u.reshape(()) for u in call["levels"]]).to(cpu, torch.float64))
                          .tolist() if call["levels"] else [])
            for fid, name, spec in self._hyper_scan():
                prior, w = log_prior(spec["prior"]), float(spec.get("w", 1.0))
                lo, hi = spec.get("bounds", (-math.inf, math.inf))
                if fid is None:  # the concentration, given the counts
                    x0 = pre.cluster_hp["alpha"].to(cpu, torch.float64).reshape(1)
                    x1 = post.cluster_hp["alpha"].to(cpu, torch.float64).reshape(1)

                    def target(v, p, c=0):
                        return ref_bbv.concentration_target(v, n, prior, p)
                else:  # a Beta hyper, column by column, the other hyper as the scan left it
                    x0, x1 = hypers[name], post.hypers[fid][name].to(cpu, torch.float64)
                    other = hypers["beta" if name == "alpha" else "alpha"]

                    def target(v, p, c=slice(None), name=name, other=other):
                        return ref_bbv.hyper_target(name, v, other[c], n, heads[:, c], prior, p)
                if control:
                    moves = [ref_slice.update(lambda v, c=c: float(target(torch.tensor([v], dtype=torch.float64),
                                                                          CONTROL, slice(c, c + 1))[0]),
                                              float(x0[c]), uniform, w, lo, hi) for c in range(x0.numel())]
                    x1 = torch.tensor([m[0] for m in moves], dtype=torch.float64)
                    log_u = torch.tensor([m[1] for m in moves], dtype=torch.float64)
                else:
                    log_u = torch.tensor([next(levels, math.inf) for _ in range(x0.numel())], dtype=torch.float64)
                if fid is not None:
                    hypers[name] = x1
                unmoved += int((x1 == x0).sum())
                gaps = ref_slice.level_gaps(log_u, target(x1, REFERENCE).reshape(-1), target(x0, REFERENCE).reshape(-1))
                widest = max(widest, float(gaps.max()))
            if not control and next(levels, None) is not None:
                widest = math.inf  # more slice updates than coordinates
        return {"slice_unmoved": unmoved, "slice_level_gap": widest}

    def _out_of_bounds(self, state) -> int:
        """Hypers outside the bounds the slice sampler was given."""
        kw = dict(self.kernels)["slice_hp"]
        bad = 0
        for fid, params in kw.get("specs", {}).items():
            for pname, spec in params.items():
                lo, hi = spec.get("bounds", (-math.inf, math.inf))
                v = state.hypers[fid][pname]
                bad += int(((v < lo) | (v > hi) | ~torch.isfinite(v)).sum())
        if "cluster" in kw:
            lo, hi = kw["cluster"].get("bounds", (-math.inf, math.inf))
            a = float(state.cluster_hp["alpha"])
            bad += int(not (lo <= a <= hi))
        return bad


def build(config, workload, seed, device, spans) -> Cell:
    return Cell(config, workload, seed, device, spans)
