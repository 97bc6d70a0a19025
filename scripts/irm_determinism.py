#!/usr/bin/env python3
"""Run-to-run equality and cost of the IRM's [N_d, K] table on one CUDA card.

    python3 scripts/irm_determinism.py

On `chip_smoke.py`'s phase 11 relation (4096 x 4096 Beta-Bernoulli, 8 x 8
planted blocks, K_max=32, one CRP start and one theta draw), it builds each
domain's table (`relational.kernels._domain_loglik_table`) twice with
`index_add_` in its default mode, whose atomic float adds land in another
order each call, and twice under `torch.use_deterministic_algorithms(True)`,
which sorts the cell indices first; it prints whether the two tables are
equal, their largest difference and the ms of one table (CUDA events, 5
calls after a warm-up), then the ms of a whole blocked sweep and whether
two 3-sweep chains from one generator seed end equal, in each mode.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import BLOCKS11, K11, N11, SEED, card_line, cuda_ms, irm_blocks  # noqa: E402


def main() -> int:
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
    try:
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode)
            for d in (0, 1):
                a, b = (rk._domain_loglik_table(s, views, theta, d) for _ in range(2))
                ms = cuda_ms(lambda: rk._domain_loglik_table(s, views, theta, d), 5)
                print(f"deterministic={mode} domain {d}: two tables equal {torch.equal(a, b)}, "
                      f"{int((a != b).sum())} of {a.numel()} entries differ, max diff "
                      f"{(a - b).abs().max().item():.3e}; {ms:.2f} ms a table")
            g1, g2 = rng(3, dev).generator, rng(3, dev).generator
            x = y = s
            for _ in range(3):
                x, y = rk.sweep(x, views, g1), rk.sweep(y, views, g2)
            same = all(torch.equal(p, q) for p, q in zip(x.assignments, y.assignments))
            print(f"deterministic={mode}: two 3-sweep chains equal {same}; "
                  f"{cuda_ms(lambda: rk.sweep(x, views, g1), 3):.2f} ms a sweep")
    finally:
        torch.use_deterministic_algorithms(False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
