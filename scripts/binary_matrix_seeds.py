#!/usr/bin/env python3
"""examples/binary_matrix.py's recipe from several generator seeds.

    python3 scripts/binary_matrix_seeds.py [--seeds 6]          # the port's example, on one CUDA card
    JAX_PLATFORMS=cpu python3 scripts/binary_matrix_seeds.py --jax [--seeds 6]   # the JAX recipe, CPU

The data are the example's (2000 x 24 binary rows of 4 planted profiles,
numpy seed 0); run s starts from init seed s and sweeps from seed
1 + 1000 s (run 0 is the example's own keys 0 and 1), 50 blocked sweeps
each followed by the slice moves. One line a run: clusters found and the
co-assignment agreement with the planted labels; then the median and the
range of the agreement. The port's run never imports JAX; `--jax` runs the
JAX package's `blocked.sweep` and `slice_.hp` (threefry keys folded per
sweep, as the example does).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _jax_run(init_seed: int, sweep_seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from common_tpu import models, scalar_functions as sf, state as st
    from common_tpu.kernels import blocked, slice_

    r = np.random.default_rng(0)
    n, d = 2000, 24
    probs = np.where(r.uniform(size=(4, d)) < 0.5, 0.1, 0.9)
    zt = r.integers(0, 4, n)
    X = (r.uniform(size=(n, d)) < probs[zt]).astype(np.float32)
    defn = st.model_definition(n, [models.bbv(d)], k_max=16)
    data = ((jnp.asarray(X), jnp.ones(n)),)
    s = st.initialize(defn, data, jax.random.key(init_seed), cluster_hp={"alpha": 1.0})
    specs = {0: {p: {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)} for p in ("alpha", "beta")}}
    cluster = {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (1e-3, 1e3)}
    for i in range(50):
        k = jax.random.fold_in(jax.random.key(sweep_seed), i)
        s = blocked.sweep(s, data, jax.random.fold_in(k, 0))
        s = slice_.hp(s, data, jax.random.fold_in(k, 1), specs, cluster=cluster)
    z = np.asarray(s.assignments)
    agree = float(((z[:, None] == z[None, :]) == (zt[:, None] == zt[None, :])).mean())
    return {"clusters": int((np.asarray(s.counts) > 0).sum()), "agreement": agree}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--jax", action="store_true", help="the JAX package's recipe on the CPU")
    args = p.parse_args()
    if args.jax:
        run = _jax_run
        print("JAX package, CPU")
    else:
        import contextlib
        import io

        import torch

        from chip_smoke import card_line
        from common_tpu_torch.examples import binary_matrix

        if not torch.cuda.is_available():
            print("binary_matrix_seeds: needs a CUDA card (or --jax)", file=sys.stderr)
            return 1
        print(card_line())

        def run(init_seed, sweep_seed):
            with contextlib.redirect_stdout(io.StringIO()):
                return binary_matrix.main("cuda", init_seed=init_seed, sweep_seed=sweep_seed)

    agree = []
    for s in range(args.seeds):
        res = run(s, 1 + 1000 * s)
        agree.append(res["agreement"])
        print(f"run {s} (init seed {s}, sweep seed {1 + 1000 * s}): {res['clusters']} clusters, "
              f"agreement {res['agreement']:.3f}", flush=True)
    print(f"agreement median {np.median(agree):.3f}, range {min(agree):.3f}-{max(agree):.3f}, "
          f"runs at or above 0.95: {sum(a >= 0.95 for a in agree)} of {len(agree)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
