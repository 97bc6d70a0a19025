"""Driver `hdp_runner`: one HDP-LDA chain through `common_tpu_torch.runner`.

The corpus is made on the device from the seed (`corpus`: document d draws
its `doc_len` words uniformly from vocabulary block d % `blocks`, a
`heldout_frac` of the positions held out, the recipe of the reference's
`bench.py` config 4), the state from `topic.initialize` on its doc-major
view, and the runner from the workload's `kernels`. Set-up runs `warmup`
runner iterations; a step of the window is `runner.run(generator, chunk)`,
which copies the chunk's traces (z, the joint score, the topic count) to the
host as users' runs do, and keeps them there until the window closes.

The comparison (`benchmark/reference/hdp.py`) judges what the window's first
and last sweeps produced (`Capture`), each stage from the program's own
inputs:

- `assign_fit_t`: the drawn z against the float64 conditional from the
  captured phi and theta, over (topic, word) cells and over the topics split
  by whether a token kept the topic it had, the larger;
- `phi_t`, `theta_t`: the captured Dirichlet draws against their float64
  parameters from a recount of the sweep's starting z;
- `crt_t`: the table counts handed to beta's Dirichlet against their exact
  CRT mean and variance given a recount of z and alpha beta;
- `beta_t`: the drawn beta against Dir(m_k + 1e-8, gamma) of those table
  counts;
- `hdp_counts`: the final count tables against an int64 recount of z
  (exact), `held_z`: held-out tokens whose z moved in the window (exact);
- `score_gap`: the joint score the runner traced for the window's last
  sweep against the float64 score of the final z, beta and hypers, relative.

`mode="control"` puts the reference in the program's place in lower
precision: its own z from bfloat16 scores, its own phi and theta drawn in
bfloat16, its own table counts from float16 probabilities, its own beta
drawn in bfloat16, the joint score in bfloat16.
"""

from __future__ import annotations

import math

import torch

from benchmark import data
from benchmark.drivers import _mixture as mx
from benchmark.reference import compare
from benchmark.reference import hdp as ref
from benchmark.reference.precision import REFERENCE

FIT_DOCS = 2048  # documents in a block of the assignment's fit


def corpus(config: dict, seed: int, device):
    """(words [D, L] int64, held [D, L] bool) of the configuration on `device`."""
    D, L, V = config["n_docs"], config["doc_len"], config["vocab"]
    spec = config["data"]
    g = data.generator(device, seed, 0)
    block = V // spec["blocks"]
    words = (torch.arange(D, device=device) % spec["blocks"])[:, None] * block
    words = words + torch.randint(0, block, (D, L), generator=g, device=device)
    held = torch.rand((D, L), generator=g, device=device) < spec["heldout_frac"]
    return words, held


class Capture(mx.FirstLast):
    """References to what the window's first and last sweeps produced: the
    state before and after the dense sweep, its phi and theta, the state the
    CRT drew from and the table counts it gave beta's Dirichlet, and beta.
    A record opens where the sweep starts and closes where beta is drawn.
    Nothing is copied."""

    def sweep_in(self, args, kwargs) -> None:
        self._cur = {"pre": args[0]}

    def draw_out(self, args, kwargs, out) -> None:
        if self._cur is not None and "draw" not in self._cur:
            self._cur["draw"] = out

    def sweep_out(self, args, kwargs, out) -> None:
        if self._cur is not None:
            self._cur["post"] = out

    def crt_in(self, args, kwargs) -> None:
        if self._cur is not None and "post" in self._cur:
            self._cur["crt_state"] = args[0]

    def tables_in(self, args, kwargs) -> None:
        if self._cur is not None and "crt_state" in self._cur:
            self._cur["m_k"] = args[0]

    def tables_out(self, args, kwargs, out) -> None:
        if self._cur is not None and "m_k" in self._cur:
            self._cur["beta"] = out
            self._close()

    def sweeps(self):
        recs = self.records()
        keys = ("pre", "draw", "post", "crt_state", "m_k", "beta")
        if recs is None or any(any(k not in r for k in keys) for r in recs):
            return None
        return recs


class Cell:
    def __init__(self, config, workload, seed, device, spans):
        from common_tpu_torch import runner as runner_mod
        from common_tpu_torch.topic import hdp

        from benchmark.drivers.mixture_runner import kernel_config

        self.config, self.workload, self.seed = config, workload, seed
        D, L, V, K = config["n_docs"], config["doc_len"], config["vocab"], config["k_topics"]
        self.shape = {"docs": D, "doc_len": L, "v": V, "k": K}
        self.words, self.held = corpus(config, seed, device)
        self.mask = (~self.held).float()
        h = config["hyper"]
        tokens = hdp.dense_token_data(self.words, self.mask)
        s0 = hdp.initialize(tokens, K, V, data.generator(device, seed, 1), alpha=h["alpha"], gamma=h["gamma"],
                            eta=h["eta"], n_docs=D)
        self.runner = runner_mod.runner(None, tokens, s0, kernel_config(workload["kernels"]))
        self.gen = data.generator(device, seed, 2)
        self.chunk = int(workload["chunk"])
        self.capture = cap = Capture()
        spans.wrap(runner_mod.HDP_KERNELS, "assign_blocked_dense", "sweep", before=cap.sweep_in,
                   after=cap.sweep_out)
        spans.wrap(runner_mod.HDP_KERNELS, "beta", None, before=cap.crt_in)
        spans.wrap(hdp, "_draw_phi_theta", None, after=cap.draw_out)
        spans.wrap(hdp, "_assign_docs", "hdp_assign")
        spans.wrap(hdp, "crt_sample", "crt")
        spans.wrap(hdp, "_beta_from_tables", None, before=cap.tables_in, after=cap.tables_out)

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
    def _counts(self, z):
        return ref.counts(z, self.words, self.mask, self.shape["k"], self.shape["v"])

    def _assign_fit(self, rec, generator) -> float:
        """assign_fit_t of one sweep: the program's z, or with a generator the
        control's own z from bfloat16 scores of the same phi and theta."""
        D, L, K, V = self.shape["docs"], self.shape["doc_len"], self.shape["k"], self.shape["v"]
        phi, theta = rec["draw"]
        phi_t = phi.T
        z_old, z_new = rec["pre"].z.reshape(D, L), rec["post"].z.reshape(D, L)
        dev = phi.device
        if bool(((z_new < 0) | (z_new >= K)).any()):
            return math.inf
        by_word = ref.CategoricalFit(V, K, dev)
        by_topic = ref.CategoricalFit(1, 2 * K, dev)
        for lo, hi in ref.blocks(D, FIT_DOCS):
            valid = self.mask[lo:hi] > 0
            w = self.words[lo:hi][valid]
            d = torch.arange(lo, hi, device=dev)[:, None].expand(hi - lo, L)[valid]
            q = ref.assign_probs(theta[d], phi_t[w])
            old = z_old[lo:hi][valid].to(torch.int64)
            if generator is None:
                new = z_new[lo:hi][valid].to(torch.int64)
            else:
                new = ref.assign_draw(theta[d], phi_t[w], generator, ref.SCORES_CONTROL)
            by_word.add(w, q, new)
            kept = torch.nn.functional.one_hot(old, K).to(torch.float64)
            by_topic.add(torch.zeros_like(w), torch.cat([q * kept, q * (1.0 - kept)], -1),
                         new + K * (new != old).to(torch.int64))
        return max(by_word.t(), by_topic.t())

    def _draw_fits(self, rec, generator):
        """(phi_t, theta_t) of one sweep's draws, or the control's own draws in bfloat16."""
        pre = rec["pre"]
        K = self.shape["k"]
        h = self.config["hyper"]
        n_dk, n_kw, _ = self._counts(pre.z)
        phi, theta = rec["draw"]
        p_phi = ref.phi_params(n_kw, h["eta"])
        if generator is not None:
            phi = ref.dirichlet_draw(p_phi, generator, ref.SCORES_CONTROL)
        fit_phi = ref.DirichletFit()
        fit_phi.add(phi, p_phi, n_kw > 0, math.ceil(ref.A_MIN / h["eta"]))
        fit_theta = ref.DirichletFit()
        alpha = pre.hypers["alpha"]
        for lo, hi in ref.blocks(n_dk.shape[0], 1 << 16):
            params = ref.theta_params(n_dk[lo:hi], alpha, pre.beta)
            x = theta[lo:hi] if generator is None else ref.dirichlet_draw(params, generator, ref.SCORES_CONTROL)
            fit_theta.add(x, params, n_dk[lo:hi] > 0, K)
        return fit_phi.t(), fit_theta.t()

    def _crt_fit(self, rec, generator) -> float:
        s = rec["crt_state"]
        K, L = self.shape["k"], self.shape["doc_len"]
        n_dk, _, _ = self._counts(s.z)
        conc = s.hypers["alpha"].to(torch.float64) * s.beta[:K].to(torch.float64)
        mean, var = ref.crt_moments(n_dk, conc, L)
        m_k = rec["m_k"] if generator is None else ref.crt_draw(n_dk, conc, L, generator, ref.CRT_CONTROL)
        return ref.crt_z(m_k, mean, var)

    def _beta_fit(self, rec, generator) -> float:
        m_k = rec["m_k"]
        params = ref.beta_params(m_k, rec["crt_state"].hypers["gamma"])[None]
        occupied = torch.cat([m_k > 0, torch.ones(1, dtype=torch.bool, device=m_k.device)])[None]
        beta = rec["beta"][None] if generator is None else ref.dirichlet_draw(params, generator, ref.SCORES_CONTROL)
        fit = ref.DirichletFit()
        fit.add(beta, params, occupied, params.shape[1])
        return fit.t()

    def readings(self, mode: str = "program") -> dict:
        names = list(self.workload["limits"])
        sweeps = self.capture.sweeps()
        if sweeps is None:
            return {name: math.inf for name in names}
        control = mode == "control"
        dev = self.words.device

        def gen(tag):
            return data.generator(dev, self.seed, tag) if control else None

        final, K = self.final, self.shape["k"]
        h = self.config["hyper"]
        n_dk, n_kw, n_k = self._counts(final.z)
        out = {"hdp_counts": 0, "held_z": 0}
        if not control:
            out["hdp_counts"] = int((final.doc_topic.to(torch.float64) != n_dk.to(torch.float64)).sum()
                                    + (final.topic_word.to(torch.float64) != n_kw.to(torch.float64)).sum()
                                    + (final.topic_total.to(torch.float64) != n_k.to(torch.float64)).sum())
            start = sweeps[0]["pre"].z.reshape(self.held.shape)
            out["held_z"] = int((final.z.reshape(self.held.shape) != start)[self.held].sum())
        out["assign_fit_t"] = max(self._assign_fit(s, gen(20 + i)) for i, s in enumerate(sweeps))
        fits = [self._draw_fits(s, gen(30 + i)) for i, s in enumerate(sweeps)]
        out["phi_t"] = max(f[0] for f in fits)
        out["theta_t"] = max(f[1] for f in fits)
        out["crt_t"] = max(self._crt_fit(s, gen(40 + i)) for i, s in enumerate(sweeps))
        out["beta_t"] = max(self._beta_fit(s, gen(50 + i)) for i, s in enumerate(sweeps))
        alpha, eta = final.hypers["alpha"], h["eta"]
        reference = ref.score_joint(n_dk, n_kw, alpha, final.beta, eta, REFERENCE)
        score = ref.score_joint(n_dk, n_kw, alpha, final.beta, eta, ref.SCORES_CONTROL) if control else self.score
        out["score_gap"] = compare.rel_gap(score, reference)
        return {**{name: math.inf for name in names}, **out}


def build(config, workload, seed, device, spans) -> Cell:
    return Cell(config, workload, seed, device, spans)
