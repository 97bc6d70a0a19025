#!/usr/bin/env python3
"""The JAX package's config-3 recipe on the CPU, on the rows of the port's chip smoke.

    JAX_PLATFORMS=cpu python scripts/config3_reference.py [--iters 11] [--key 0]

BASELINE config 3 as `bench.py:run_config3_tier` runs it (bench.py:903-1007):
a DP mixture of niw(16) + gp + bb columns, K_max=32, alpha=1, the recipe's
hypers and Exp(1) priors, each iteration one plain blocked sweep, `hmc.hp`
over the gp and bb hypers and `hmc.cluster_hp` over alpha (2 NUTS
transitions of depth at most 5 each), compiled as one `lax.scan`. The rows
are `chip_smoke.config3_rows()` (numpy seed 0: 100,000 rows plus 2,048
held out), so the held-out log density per row it prints is the reference
for phase 9 of `chip_smoke.py` on the same data; the port's phase 9 runs
1 + 10 iterations, the default here. Prints one JSON line: the held-out
logp/row, the final alpha and hypers, k_active at the CRP start and at the
end, and the compile and run times on this CPU. This script is the one
place of the repo that runs the JAX package on the port's data; the port
itself never imports JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=11, help="iterations of the recipe's scan")
    ap.add_argument("--key", type=int, default=0, help="JAX key of the CRP start and the chain")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from chip_smoke import HELD9, K9, N9, config3_hypers, config3_rows
    from common_tpu import models, scalar_functions
    from common_tpu import state as st
    from common_tpu.kernels import blocked, hmc

    t_start = time.perf_counter()
    xg, xp, xb = config3_rows()
    dg = xg.shape[1]
    ones, ones_h = jnp.ones(N9, jnp.float32), jnp.ones(HELD9, jnp.float32)
    data = tuple((jnp.asarray(c[:N9]), ones) for c in (xg, xp, xb))
    held = tuple((jnp.asarray(c[N9:]), ones_h) for c in (xg, xp, xb))
    defn = st.model_definition(N9, [models.niw(dg), models.gp, models.bb], k_max=K9)
    key = jax.random.key(args.key)
    state = st.initialize(defn, data, jax.random.fold_in(key, 1), cluster_hp={"alpha": 1.0},
                          feature_hps=config3_hypers())
    exp1 = scalar_functions.log_exponential(1.0)
    priors = {1: lambda h: exp1(h["alpha"]) + exp1(h["inv_beta"]),
              2: lambda h: exp1(h["alpha"]) + exp1(h["beta"])}

    def run(state, data, key):
        def body(s, t):
            kt = jax.random.fold_in(key, t)
            s = blocked.sweep(s, data, jax.random.fold_in(kt, 0))
            s = hmc.hp(s, data, jax.random.fold_in(kt, 1), priors, num_steps=2, max_depth=5)
            s = hmc.cluster_hp(s, jax.random.fold_in(kt, 2), exp1, num_steps=2, max_depth=5)
            return s, st.score_joint(s)

        return jax.lax.scan(body, state, jnp.arange(args.iters))

    t0 = time.perf_counter()
    compiled = jax.jit(run).lower(state, data, key).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, trace = compiled(state, data, jax.random.fold_in(key, 2))
    out.counts.block_until_ready()
    run_s = time.perf_counter() - t0
    lp_row = float(jnp.mean(jax.jit(lambda s: st.heldout_logp(s, held))(out)))
    print(json.dumps({
        "config": "3: niw16 + gp + bb, blocked sweep + NUTS hp + NUTS alpha (bench.py:903-1007)",
        "rows": N9, "heldout_rows": HELD9, "k_max": K9, "iters": args.iters, "key": args.key,
        "heldout_logp_per_row": lp_row, "score_final": float(trace[-1]),
        "k_active_start": int(jnp.sum(state.counts > 0)), "k_active": int(jnp.sum(out.counts > 0)),
        "alpha": float(out.cluster_hp["alpha"]),
        "gp": {k: float(v) for k, v in out.hypers[1].items()},
        "bb": {k: float(v) for k, v in out.hypers[2].items()},
        "compile_s": compile_s, "run_s": run_s, "total_s": time.perf_counter() - t_start,
        "device": str(jax.devices()[0]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
