#!/usr/bin/env python3
"""How often one blocked IRM chain recovers planted blocks, by start.

    python3 scripts/irm_starts.py                        # the port, on one CUDA card, 4096 x 4096
    JAX_PLATFORMS=cpu python3 scripts/irm_starts.py --jax --n 512   # the JAX package, on the CPU

The relation is `chip_smoke.py`'s phase 11 relation (`irm_blocks`: 8 x 8
planted blocks, numpy seed 0) at n x n, Beta-Bernoulli, K_max=32 in both
domains, alpha=1. For each start kind and seed, one chain of blocked
sweeps; after 30 and 60 sweeps it prints the co-assignment agreement of
each domain with the planted labels and the clusters in use. Start kinds:
`crp` (each domain a CRP draw), `uniform-K` (each entity uniform over the
first K slots). The port's run never imports JAX; `--jax` runs the JAX
package's `relational.kernels` on the CPU (`n` of a few hundred there).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line, irm_blocks  # noqa: E402

KINDS = ("uniform-32", "crp", "uniform-8", "uniform-16")
K_MAX, CHECKS = 32, (30, 60)


def _agreement(z, zt) -> float:
    z = np.asarray(z)
    return float(((z[:, None] == z[None, :]) == (zt[:, None] == zt[None, :])).mean())


def _start(kind: str, n: int, seed: int):
    if kind == "crp":
        return None
    k = int(kind.split("-")[1])
    r = np.random.default_rng(seed)
    return [r.integers(0, k, n).astype(np.int32) for _ in range(2)]


def run_port(n: int, seeds: int) -> None:
    import torch

    from common_tpu_torch import models, rng
    from common_tpu_torch import relational as irm
    from common_tpu_torch.data import sparse_ndarray_dataview
    from common_tpu_torch.relational import kernels

    if not torch.cuda.is_available():
        sys.exit("irm_starts: no CUDA device (use --jax for the JAX package on the CPU)")
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    rel, zt = irm_blocks(n, 8, 0)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device=dev)])
    defn = irm.model_definition([n, n], [((0, 1), models.bb)], k_max=K_MAX)
    t0 = time.time()
    for kind in KINDS:
        for seed in range(seeds):
            s = irm.initialize(defn, views, rng(seed, dev).generator, domain_assignments=_start(kind, n, seed))
            g = rng(1000 + seed, dev).generator
            out = []
            for i in range(max(CHECKS)):
                s = kernels.sweep(s, views, g)
                if i + 1 in CHECKS:
                    out.append([round(_agreement(z.cpu(), zt), 4) for z in s.assignments]
                               + [int(s.ngroups(d)) for d in range(2)])
            print(f"port {kind} seed {seed}: after {CHECKS} sweeps [rows, cols, k_rows, k_cols] {out} "
                  f"({time.time() - t0:.0f} s)", flush=True)


def run_jax(n: int, seeds: int) -> None:
    import jax

    from common_tpu import models
    from common_tpu import relational as irm
    from common_tpu.data.sparse import sparse_ndarray_dataview

    rel, zt = irm_blocks(n, 8, 0)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel)])
    defn = irm.model_definition([n, n], [((0, 1), models.bb)], k_max=K_MAX)

    @jax.jit
    def chain(s, key):
        def body(st, k):
            return irm.kernels._sweep_jit(st, views, k, (False, False)), None
        return jax.lax.scan(body, s, jax.random.split(key, CHECKS[0]))[0]

    for kind in KINDS:
        for seed in range(seeds):
            s = irm.initialize(defn, views, jax.random.key(seed), domain_assignments=_start(kind, n, seed))
            out = []
            for i, _ in enumerate(CHECKS):
                s = chain(s, jax.random.key(1000 * (i + 1) + seed))
                out.append([round(_agreement(z, zt), 4) for z in s.assignments]
                           + [int((c > 0).sum()) for c in s.counts])
            print(f"jax {kind} seed {seed}: after {CHECKS} sweeps [rows, cols, k_rows, k_cols] {out}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax", action="store_true", help="run the JAX package on the CPU")
    ap.add_argument("--n", type=int, default=4096, help="entities a domain")
    ap.add_argument("--seeds", type=int, default=6, help="chains of each start kind")
    args = ap.parse_args()
    (run_jax if args.jax else run_port)(args.n, args.seeds)


if __name__ == "__main__":
    main()
