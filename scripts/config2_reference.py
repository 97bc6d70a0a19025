#!/usr/bin/env python3
"""The JAX package's config-2 recipe on the CPU, on the rows of the port bench.

    JAX_PLATFORMS=cpu python scripts/config2_reference.py [--seeds 0 1 2] [--key 0] [--port | --port-start]

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
(seed, key), so the two differ only in the chain's transitions. Prints
one JSON line a seed, with the run times on this CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N, D, K, ITERS, HELD = 100_000, 64, 32, 8, 4096


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2], help="port bench seeds of the rows")
    ap.add_argument("--key", type=int, default=0, help="key of the CRP start and the chain")
    ap.add_argument("--port", action="store_true", help="run the port's chain on the CPU instead")
    ap.add_argument("--port-start", action="store_true", help="start the JAX chain from the port's CRP start")
    args = ap.parse_args()
    if args.port:
        return _port(args)

    import jax
    import jax.numpy as jnp

    from common_tpu import models, scalar_functions
    from common_tpu import state as st
    from common_tpu.kernels import blocked, slice_
    from common_tpu_torch import bench as port_bench

    defn = st.model_definition(N, [models.bbv(D)], k_max=K)
    beta_hp = {"prior": scalar_functions.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)}
    specs = {0: {"alpha": beta_hp, "beta": beta_hp}}
    cluster = {"prior": scalar_functions.log_exponential(1.0), "w": 0.5, "bounds": (1e-4, 1e4)}

    def run(state, x, key):
        data = ((x, jnp.ones(N, jnp.float32)),)

        def body(s, t):
            kt = jax.random.fold_in(key, t)
            s = blocked.sweep(s, data, jax.random.fold_in(kt, 0))
            s = slice_._hp_impl(s, jax.random.fold_in(kt, 1), specs=specs, cluster=cluster)
            return s, st.score_joint(s)

        return jax.lax.scan(body, state, jnp.arange(ITERS))

    compiled = None
    for seed in args.seeds:
        rows = port_bench.binary_rows(port_bench._rows_rng(seed, 21, 0), N + HELD, D)
        x, xh = jnp.asarray(rows[:N]), jnp.asarray(rows[N:])
        key = jax.random.fold_in(jax.random.key(args.key), seed)
        start = _port_start(seed, args.key) if args.port_start else None
        state = st.initialize(defn, ((x, jnp.ones(N, jnp.float32)),), jax.random.fold_in(key, 1),
                              cluster_hp={"alpha": 1.0}, assignment=start,
                              feature_hps=[{"alpha": jnp.ones(D), "beta": jnp.ones(D)}])
        t0 = time.perf_counter()
        if compiled is None:
            compiled = jax.jit(run).lower(state, x, key).compile()
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, trace = compiled(state, x, jax.random.fold_in(key, 2))
        out.counts.block_until_ready()
        run_s = time.perf_counter() - t0
        mean_lp = float(jnp.mean(st.heldout_logp(out, ((xh, jnp.ones(HELD, jnp.float32)),))))
        print(json.dumps({
            "config": "2: bbv(64), blocked sweep + slice hp (bench.py:759-900), the JAX package on the CPU",
            "rows": f"common_tpu_torch.bench config-2 rows of --seed {seed}", "key": args.key,
            "start": "the port's CRP start" if args.port_start else "the JAX package's CRP start",
            "k_start": int(jnp.sum(state.counts > 0)),
            "mean_logp": round(mean_lp, 4), "per_dim": round(mean_lp / D, 5),
            "k_active": int(jnp.sum(out.counts > 0)), "alpha": float(out.cluster_hp["alpha"]),
            "score_final": float(trace[-1]), "compile_s": round(compile_s, 1), "run_s": round(run_s, 1),
        }), flush=True)
    return 0


def _port_start(seed: int, key: int):
    """The port's CRP start of (seed, key), as `--port` draws it: [N] int32."""
    import numpy as np
    import torch

    from common_tpu_torch import bench as port_bench
    from common_tpu_torch import state as st

    z = st.sample_crp_assignment(port_bench._generator(torch.device("cpu"), seed, 1000 + key, 1), N, K, 1.0)
    return np.asarray(z.numpy(), np.int32)


def _port(args) -> int:
    import numpy as np
    import torch

    from common_tpu_torch import bench as port_bench
    from common_tpu_torch import models
    from common_tpu_torch import state as st
    from common_tpu_torch.kernels import blocked, slice_

    cpu = torch.device("cpu")
    defn = st.model_definition(N, [models.bbv(D)], k_max=K)
    hp_kw = port_bench.config2_hp_specs()
    for seed in args.seeds:
        rows = port_bench.binary_rows(port_bench._rows_rng(seed, 21, 0), N + HELD, D)
        data, held = port_bench._columns(rows[:N], cpu), port_bench._columns(rows[N:], cpu)
        s = st.initialize(defn, data, port_bench._generator(cpu, seed, 1000 + args.key, 1), cluster_hp={"alpha": 1.0},
                          feature_hps=[{"alpha": np.ones(D, np.float32), "beta": np.ones(D, np.float32)}])
        gen = port_bench._generator(cpu, seed, 1000 + args.key, 2)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            s = slice_.hp(blocked.sweep(s, data, gen), data, gen, **hp_kw)
        run_s = time.perf_counter() - t0
        mean_lp = float(st.heldout_logp(s, held).mean())
        print(json.dumps({
            "config": "2: bbv(64), blocked sweep + slice hp, the port on the CPU",
            "rows": f"common_tpu_torch.bench config-2 rows of --seed {seed}", "key": args.key,
            "mean_logp": round(mean_lp, 4), "per_dim": round(mean_lp / D, 5),
            "k_active": int((s.counts > 0).sum()), "alpha": float(s.cluster_hp["alpha"]),
            "score_final": float(st.score_joint(s)), "run_s": round(run_s, 1),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
