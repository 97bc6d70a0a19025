#!/usr/bin/env python3
"""Run-to-run equality and cost of the IRM's blocked sweep on one CUDA card:
the order-fixed segment sums (`common_tpu_torch.utils.segment`) against the
atomic `index_add_` route they replaced.

    python3 scripts/irm_determinism.py

On `chip_smoke.py`'s phase 11 relation (4096 x 4096 Beta-Bernoulli, 8 x 8
planted blocks, K_max=32, one CRP start and one theta draw). First, on a
fresh view, the first table of each domain (which builds its cell order),
a restat and one blocked sweep under `torch.cuda.set_sync_debug_mode("error")`.
Then for each route, in turns (segment, atomic, atomic, segment): each
domain's table (`relational.kernels._domain_loglik_table`) built twice, whether
the two are equal, how many entries differ and by how much, the ms of one
table and of the restat (CUDA events, 5 calls after a warm-up), two 3-sweep
chains from one generator seed and whether they end equal (assignments,
counts, suffstats), and the ms of one sweep. The atomic route is the table
and restat as they were before the segment sums, kept here as the
yardstick and swapped into `relational.kernels` for its turns. The first
line is the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import BLOCKS11, K11, N11, SEED, card_line, cuda_ms, irm_blocks  # noqa: E402


def _atomic_table(state, views, thetas, domain: int):
    """The blocked table with `index_add_` of each chunk's float logpdfs (the
    yardstick: on a card its atomic adds land in another order each call)."""
    import torch

    from common_tpu_torch.relational import kernels as rk

    n_d = state.assignments[domain].shape[-1]
    K = state.counts[domain].shape[-1]
    liks = state.likelihoods()
    dt = next(iter(thetas[0].values())).dtype
    table = torch.zeros((n_d, K), dtype=dt, device=state.device)
    chunk = max(1, rk.TABLE_ELEMS // K)
    for r, view in enumerate(views):
        doms = state.rel_domains[r]
        for axis, dom in enumerate(doms):
            if dom != domain:
                continue
            for lo in range(0, view.indices.shape[0], chunk):
                ind = view.indices[lo:lo + chunk]
                th = rk._theta_at_cells(thetas[r], doms, state.assignments, ind, axis)
                lp = liks[r].logpdf(th, view.values[lo:lo + chunk, None])
                lp = lp * view.mask[lo:lo + chunk, None].to(lp.dtype)
                table.index_add_(0, ind[:, axis], lp)
    return table


def _atomic_stats(lik, hyper, rel_domains, assignments, view, k_maxes):
    """The suffstat rebuild with one `index_add_` a leaf (the yardstick)."""
    import numpy as np
    import torch

    from common_tpu_torch.relational import state as irm_state

    shape = tuple(k_maxes[d] for d in rel_domains)
    total = int(np.prod(shape))
    bins = irm_state._cell_bins(rel_domains, assignments, view.indices, k_maxes)
    out = {}
    for k, t in lik.tx(hyper, view.values, view.mask).items():
        flat = torch.zeros((total, *t.shape[1:]), dtype=t.dtype, device=t.device)
        out[k] = flat.index_add_(0, bins, t).reshape(*shape, *t.shape[1:])
    return out


@contextlib.contextmanager
def _route(name: str):
    """`relational.kernels` on the named route inside, the shipped one after."""
    from common_tpu_torch.relational import kernels as rk
    from common_tpu_torch.relational import state as irm_state

    if name == "segment":
        yield
        return
    saved = rk._domain_loglik_table, irm_state.compute_relation_stats
    rk._domain_loglik_table, irm_state.compute_relation_stats = _atomic_table, _atomic_stats
    try:
        yield
    finally:
        rk._domain_loglik_table, irm_state.compute_relation_stats = saved


def _same(a, b) -> bool:
    import torch

    return (all(torch.equal(x, y) for x, y in zip(a.assignments + a.counts, b.assignments + b.counts))
            and all(torch.equal(x[k], y[k]) for x, y in zip(a.suffstats, b.suffstats) for k in x))


def main() -> int:
    import numpy as np
    import torch

    from common_tpu_torch import models, rng
    from common_tpu_torch import relational as irm
    from common_tpu_torch.data import sparse_ndarray_dataview
    from common_tpu_torch.relational import kernels as rk

    if not torch.cuda.is_available():
        print("irm_determinism: needs a CUDA card", file=sys.stderr)
        return 1
    print(card_line())
    dev = torch.device("cuda")
    rel, _ = irm_blocks(N11, BLOCKS11, SEED)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device=dev)])
    defn = irm.model_definition([N11, N11], [((0, 1), models.bb)], k_max=K11)
    s = irm.initialize(defn, views, rng(1, dev).generator, cluster_hps=[{"alpha": 1.0}] * 2)
    theta = rk._sample_block_params(s, rng(2, dev).generator)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for d in (0, 1):
            rk._domain_loglik_table(s, views, theta, d)
        rk.restat(s, views)
        rk.sweep(s, views, rng(3, dev).generator)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("first tables (cell orders built), a restat and a sweep under set_sync_debug_mode('error'): no host wait")

    rec = {"segment": [], "atomic": []}
    for name in ("segment", "atomic", "atomic", "segment"):
        with _route(name):
            row = {}
            for d in (0, 1):
                a, b = (rk._domain_loglik_table(s, views, theta, d) for _ in range(2))
                row[f"table{d}_differ"] = int((a != b).sum())
                row[f"table{d}_max_diff"] = (a - b).abs().max().item()
                row[f"table{d}_ms"] = cuda_ms(lambda d=d: rk._domain_loglik_table(s, views, theta, d), 5)
            row["restat_ms"] = cuda_ms(lambda: rk.restat(s, views), 5)
            g1, g2 = rng(3, dev).generator, rng(3, dev).generator
            x = y = s
            for _ in range(3):
                x, y = rk.sweep(x, views, g1), rk.sweep(y, views, g2)
            row["chains_equal"] = _same(x, y)
            row["sweep_ms"] = cuda_ms(lambda: rk.sweep(x, views, g1), 5)
            rec[name].append(row)
        print(f"{name:7s}: tables differ in {row['table0_differ']} / {row['table1_differ']} of {N11 * K11} "
              f"entries (max diff {row['table0_max_diff']:.3e} / {row['table1_max_diff']:.3e}); "
              f"{row['table0_ms']:.2f} / {row['table1_ms']:.2f} ms a table, restat {row['restat_ms']:.2f} ms; "
              f"two 3-sweep chains equal {row['chains_equal']}; {row['sweep_ms']:.2f} ms a sweep")
    mean = {n: {k: float(np.mean([r[k] for r in rows])) for k in ("table0_ms", "table1_ms", "restat_ms", "sweep_ms")}
            for n, rows in rec.items()}
    ratio = mean["segment"]["sweep_ms"] / mean["atomic"]["sweep_ms"]
    print(f"mean of two turns, segment / atomic: tables {mean['segment']['table0_ms']:.2f} / "
          f"{mean['atomic']['table0_ms']:.2f} and {mean['segment']['table1_ms']:.2f} / "
          f"{mean['atomic']['table1_ms']:.2f} ms, restat {mean['segment']['restat_ms']:.2f} / "
          f"{mean['atomic']['restat_ms']:.2f} ms, sweep {mean['segment']['sweep_ms']:.2f} / "
          f"{mean['atomic']['sweep_ms']:.2f} ms ({ratio:.3f}x)")
    seg = rec["segment"]
    ok = all(r["table0_differ"] == 0 and r["table1_differ"] == 0 and r["chains_equal"] for r in seg)
    print(f"segment route replays: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
