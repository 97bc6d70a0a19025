#!/usr/bin/env python3
"""The JAX package's config-2 recipe on the CPU, on the rows of the port bench.

    JAX_PLATFORMS=cpu python scripts/config2_reference.py [--seeds 0 1 2] [--key 0 ...]
        [--port | --port-start | --clamp-reference]
    python scripts/config2_reference.py --tally FILE ...

BASELINE config 2 as `bench.py:run_config2_tier` runs its plain chain
(bench.py:759-900): a Beta-Bernoulli DP mixture over 64 binary columns (one
bbv feature), K_max=32, alpha=1, unit Beta hypers, each iteration one plain
blocked sweep and `slice_._hp_impl` over the per-column hypers (bounds
(0.5, 50)) and the CRP alpha (bounds (1e-4, 1e4)), 8 iterations compiled as
one `lax.scan`. The rows of each `--seeds` value are the port bench's
(`common_tpu_torch.bench.binary_rows` from its config-2 stream: 100,000
rows plus 4,096 held out), so the held-out mean log density a row it prints
is the reference for the port bench's `configs.config2.predictive` at
`--seed` of the same value. `--port` runs the port's chain (`blocked.sweep`
and `slice_.hp` at the bench's settings, `config2_hp_specs`) on the CPU in
its place, from a CRP start and generator seeded from (seed, key), so the
two packages' chains can be compared on the same rows from many starts;
`--port-start` runs the JAX chain from the port's CRP start of the same
(seed, key), so the two differ only in the chain's transitions.
`--clamp-reference` runs the JAX chain with bbv's Beta draw clamped to
[finfo.tiny, 1 - finfo.eps / 2] of float32, as the port's `rng.beta_open`
clamps it: the JAX package's `sample_params` is wrapped in this process
only, and no file of `common_tpu/` changes. Every JAX chain also counts,
per iteration, the draws of its sweep's theta that are exactly 1.0
(`ones`, redrawn unclamped from the sweep's own key before the sweep)
beside its k_active (`k_trace`): an unclamped draw of 1.0 makes log(1 -
p) = -inf, every row's score in that slot NaN, and `jnp.argmax` puts
every row there.

Prints one JSON line a (seed, key), with the run times on this CPU.
`--tally` reads such lines (from one file an arm or mixed) and prints, per
arm, the chains at the mode, those whose mean_logp lies within 0.01 of the
best of any line of the same seed, and Fisher's exact p of each pair of arms.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N, D, K, ITERS, HELD = 100_000, 64, 32, 8, 4096
MODE_TOL = 0.01  # a chain within this of its seed's best mean_logp is at the mode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2], help="port bench seeds of the rows")
    ap.add_argument("--key", type=int, nargs="+", default=[0], help="keys of the CRP start and the chain")
    ap.add_argument("--port", action="store_true", help="run the port's chain on the CPU instead")
    ap.add_argument("--port-start", action="store_true", help="start the JAX chain from the port's CRP start")
    ap.add_argument("--clamp-reference", action="store_true",
                    help="clamp the JAX package's bbv draw inside (0, 1) as the port does")
    ap.add_argument("--tally", nargs="+", metavar="FILE", help="count the chains at the mode in these lines")
    args = ap.parse_args()
    if args.tally:
        return _tally(args.tally)
    if args.port:
        return _port(args)

    import jax
    import jax.numpy as jnp

    from common_tpu import likelihoods as jlik
    from common_tpu import models, scalar_functions
    from common_tpu import state as st
    from common_tpu.kernels import blocked, slice_
    from common_tpu_torch import bench as port_bench

    raw_draw = type(jlik.bbv).sample_params
    if args.clamp_reference:
        _clamp_reference_draw(jlik.bbv)
    arm = "jax_clamped" if args.clamp_reference else "jax_port_start" if args.port_start else "jax"

    defn = st.model_definition(N, [models.bbv(D)], k_max=K)
    beta_hp = {"prior": scalar_functions.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)}
    specs = {0: {"alpha": beta_hp, "beta": beta_hp}}
    cluster = {"prior": scalar_functions.log_exponential(1.0), "w": 0.5, "bounds": (1e-4, 1e4)}

    def run(state, x, key):
        data = ((x, jnp.ones(N, jnp.float32)),)

        def body(s, t):
            kt = jax.random.fold_in(key, t)
            k_sweep = jax.random.fold_in(kt, 0)
            # the sweep's theta, redrawn unclamped from its key as `blocked.sweep_parts` draws it
            k_theta = jax.random.fold_in(jax.random.split(k_sweep)[0], 0)
            ones = jnp.sum(raw_draw(jlik.bbv, k_theta, s.hypers[0], s.stats[0])["p"] == 1.0)
            s = blocked.sweep(s, data, k_sweep)
            s = slice_._hp_impl(s, jax.random.fold_in(kt, 1), specs=specs, cluster=cluster)
            return s, (st.score_joint(s), ones, jnp.sum(s.counts > 0))

        return jax.lax.scan(body, state, jnp.arange(ITERS))

    compiled = None
    for seed, k in [(seed, k) for seed in args.seeds for k in args.key]:
        rows = port_bench.binary_rows(port_bench._rows_rng(seed, 21, 0), N + HELD, D)
        x, xh = jnp.asarray(rows[:N]), jnp.asarray(rows[N:])
        key = jax.random.fold_in(jax.random.key(k), seed)
        start = _port_start(seed, k) if args.port_start else None
        state = st.initialize(defn, ((x, jnp.ones(N, jnp.float32)),), jax.random.fold_in(key, 1),
                              cluster_hp={"alpha": 1.0}, assignment=start,
                              feature_hps=[{"alpha": jnp.ones(D), "beta": jnp.ones(D)}])
        t0 = time.perf_counter()
        if compiled is None:
            compiled = jax.jit(run).lower(state, x, key).compile()
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, (trace, ones, k_trace) = compiled(state, x, jax.random.fold_in(key, 2))
        out.counts.block_until_ready()
        run_s = time.perf_counter() - t0
        mean_lp = float(jnp.mean(st.heldout_logp(out, ((xh, jnp.ones(HELD, jnp.float32)),))))
        print(json.dumps({
            "config": "2: bbv(64), blocked sweep + slice hp (bench.py:759-900), the JAX package on the CPU",
            "arm": arm, "seed": seed, "key": k,
            "rows": f"common_tpu_torch.bench config-2 rows of --seed {seed}",
            "start": "the port's CRP start" if args.port_start else "the JAX package's CRP start",
            "draw": "clamped inside (0, 1)" if args.clamp_reference else "the JAX package's, unclamped",
            "k_start": int(jnp.sum(state.counts > 0)),
            "mean_logp": round(mean_lp, 4), "per_dim": round(mean_lp / D, 5),
            "k_active": int(jnp.sum(out.counts > 0)), "alpha": float(out.cluster_hp["alpha"]),
            "ones": [int(v) for v in ones], "k_trace": [int(v) for v in k_trace],
            "score_final": float(trace[-1]), "compile_s": round(compile_s, 1), "run_s": round(run_s, 1),
        }), flush=True)
    return 0


def _clamp_reference_draw(lik) -> None:
    """Wrap the JAX package's bbv `sample_params` (its class's, in this
    process) so that its draw lies in [finfo.tiny, 1 - finfo.eps / 2] of
    float32, what the port's `rng.beta_open` does to its own draw."""
    import jax.numpy as jnp

    cls = type(lik)
    raw = cls.sample_params
    fi = jnp.finfo(jnp.float32)

    def sample_params(self, key, hyper, stats):
        return {"p": jnp.clip(raw(self, key, hyper, stats)["p"], fi.tiny, 1.0 - fi.eps / 2)}

    cls.sample_params = sample_params


def _tally(paths) -> int:
    """Chains at the mode by arm, and Fisher's exact p of each pair of arms."""
    from itertools import combinations

    from scipy.stats import fisher_exact

    lines = [json.loads(ln) for p in paths for ln in Path(p).read_text().splitlines() if ln.startswith("{")]
    best = {}
    for r in lines:
        best[r["seed"]] = max(best.get(r["seed"], -np.inf), r["mean_logp"])
    arms = {}
    for r in lines:
        arms.setdefault(r["arm"], []).append(r["mean_logp"] >= best[r["seed"]] - MODE_TOL)
    out = {"best_mean_logp": {str(s): v for s, v in sorted(best.items())},
           "at_mode": {a: f"{sum(v)}/{len(v)}" for a, v in arms.items()},
           "fisher_p": {f"{a} vs {b}": float(fisher_exact([[sum(arms[a]), len(arms[a]) - sum(arms[a])],
                                                            [sum(arms[b]), len(arms[b]) - sum(arms[b])]])[1])
                        for a, b in combinations(arms, 2)}}
    print(json.dumps(out))
    return 0


def _port_start(seed: int, key: int):
    """The port's CRP start of (seed, key), as `--port` draws it: [N] int32."""
    import torch

    from common_tpu_torch import bench as port_bench
    from common_tpu_torch import state as st

    z = st.sample_crp_assignment(port_bench._generator(torch.device("cpu"), seed, 1000 + key, 1), N, K, 1.0)
    return np.asarray(z.numpy(), np.int32)


def _port(args) -> int:
    import torch

    from common_tpu_torch import bench as port_bench
    from common_tpu_torch import models
    from common_tpu_torch import state as st
    from common_tpu_torch.kernels import blocked, slice_

    cpu = torch.device("cpu")
    defn = st.model_definition(N, [models.bbv(D)], k_max=K)
    hp_kw = port_bench.config2_hp_specs()
    for seed, k in [(seed, k) for seed in args.seeds for k in args.key]:
        rows = port_bench.binary_rows(port_bench._rows_rng(seed, 21, 0), N + HELD, D)
        data, held = port_bench._columns(rows[:N], cpu), port_bench._columns(rows[N:], cpu)
        s = st.initialize(defn, data, port_bench._generator(cpu, seed, 1000 + k, 1), cluster_hp={"alpha": 1.0},
                          feature_hps=[{"alpha": np.ones(D, np.float32), "beta": np.ones(D, np.float32)}])
        gen = port_bench._generator(cpu, seed, 1000 + k, 2)
        k_trace = []
        t0 = time.perf_counter()
        for _ in range(ITERS):
            s = slice_.hp(blocked.sweep(s, data, gen), data, gen, **hp_kw)
            k_trace.append(int((s.counts > 0).sum()))
        run_s = time.perf_counter() - t0
        mean_lp = float(st.heldout_logp(s, held).mean())
        print(json.dumps({
            "config": "2: bbv(64), blocked sweep + slice hp, the port on the CPU",
            "arm": "port", "seed": seed, "key": k,
            "rows": f"common_tpu_torch.bench config-2 rows of --seed {seed}",
            "mean_logp": round(mean_lp, 4), "per_dim": round(mean_lp / D, 5),
            "k_active": int((s.counts > 0).sum()), "alpha": float(s.cluster_hp["alpha"]),
            "k_trace": k_trace, "score_final": float(st.score_joint(s)), "run_s": round(run_s, 1),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
