#!/usr/bin/env python3
"""Each cell of several `python -m common_tpu_torch.bench` runs: the runs'
values, their median and their spread (max - min, and that over the median).

    python3 scripts/bench_spread.py RUN.json [RUN.json ...]

Each file holds a bench run's standard output; its last line is the result.
Prints a markdown table, one row a cell, and the runs' devices.
"""

from __future__ import annotations

import json
import sys

import numpy as np

# (row label, path into the result line); a path step that is an int indexes a list
CELLS = [
    ("value: top sweeps/s", ("value",)),
    ("tflops", ("tflops",)),
    ("mfu", ("mfu",)),
    ("ladder 20k x 16 sweeps/s", ("tiers", 0, "sweeps_per_s")),
    ("ladder 100k x 64 sweeps/s", ("tiers", 1, "sweeps_per_s")),
    ("ladder 250k x 128 sweeps/s", ("tiers", 2, "sweeps_per_s")),
    ("ladder 500k x 256 sweeps/s", ("tiers", 3, "sweeps_per_s")),
    ("ladder 1M x 256 sweeps/s", ("tiers", 4, "sweeps_per_s")),
    ("fused tier sweeps/s (top ladder shape)", ("fused_tier", "sweeps_per_s")),
    ("ESS tier sweeps/s (with the trace)", ("ess_tier", "sweeps_per_s")),
    ("ESS/s, mean over seeds", ("ess_per_s",)),
    ("ESS/s spread over seeds", ("ess_per_s_spread",)),
    ("ESS of seed 0 (of 240 kept)", ("ess_tier", "seeds", 0, "ess_min")),
    ("ESS of seed 1", ("ess_tier", "seeds", 1, "ess_min")),
    ("ESS of seed 2", ("ess_tier", "seeds", 2, "ess_min")),
    ("held-out per_dim, seed 0", ("ess_tier", "seeds", 0, "heldout_per_dim")),
    ("held-out per_dim, seed 1", ("ess_tier", "seeds", 1, "heldout_per_dim")),
    ("held-out per_dim, seed 2", ("ess_tier", "seeds", 2, "heldout_per_dim")),
    ("k_active after 300 sweeps (last seed)", ("ess_tier", "k_active")),
    ("main path held-out per_dim (300 sweeps)", ("predictive", "per_dim")),
    ("HDP sweeps/s", ("hdp", "sweeps_per_s")),
    ("HDP tokens/s", ("hdp", "tokens_per_s")),
    ("HDP perplexity after 3 sweeps", ("hdp", "predictive", "perplexity_timed")),
    ("HDP perplexity after 18 sweeps", ("hdp", "predictive", "perplexity")),
    ("chains 65536 x 16, C=1 chain-sweeps/s", ("efficiency", "chains_on_chip", "chain_sweeps_per_s", "1")),
    ("chains 65536 x 16, C=4 chain-sweeps/s", ("efficiency", "chains_on_chip", "chain_sweeps_per_s", "4")),
    ("chains scaling efficiency C=4 / C=1", ("efficiency", "chains_on_chip", "efficiency")),
    ("chains 1M x 256, C=4 chain-sweeps/s", ("chains_headline", "chains", "4", "aggregate_chain_sweeps_per_s")),
    ("chains vs single chain", ("chains_headline", "vs_single_chain")),
    ("config 2 plain iterations/s", ("configs", "config2", "sweeps_per_s")),
    ("config 2 fused iterations/s", ("configs", "config2", "fused", "sweeps_per_s")),
    ("config 2 held-out mean_logp", ("configs", "config2", "predictive", "mean_logp")),
    ("config 2 k_active", ("configs", "config2", "k_active")),
    ("config 3 iterations/s", ("configs", "config3", "sweeps_per_s")),
    ("config 3 held-out mean_logp", ("configs", "config3", "predictive", "mean_logp")),
    ("config 3 k_active", ("configs", "config3", "k_active")),
    ("config 5 rows/s", ("smc", "rows_per_s")),
    ("config 5 logz", ("smc", "logz")),
    ("config 5 held-out per_dim", ("smc", "predictive", "per_dim")),
    ("config 5 resamples", ("smc", "n_resamples")),
    ("split-merge arm ESS/s", ("ess_tier_sm", "ess_per_s")),
    ("split-merge arm sweeps/s", ("ess_tier_sm", "sweeps_per_s")),
    ("plain arm ESS/s", ("ess_tier_sm", "ab_plain_ess_per_s")),
    ("plain arm sweeps/s", ("ess_tier_sm", "ab_plain_sweeps_per_s")),
    ("baseline sweeps/s (numpy, 1M rows)", ("baseline_sweeps_per_s",)),
    ("vs_baseline", ("vs_baseline",)),
    ("kernel build s", ("build_s",)),
    ("whole run s", ("total_s",)),
]


def _get(result, path):
    for step in path:
        try:
            result = result[step]
        except (KeyError, IndexError, TypeError):
            return None
    return result


def main(paths) -> int:
    runs = []
    for p in paths:
        with open(p) as f:
            runs.append(json.loads(f.read().strip().splitlines()[-1]))
    print("| cell | " + " | ".join(f"run {i + 1}" for i in range(len(runs))) + " | median | spread | spread / median |")
    print("| --- |" + " --- |" * (len(runs) + 3))
    for label, path in CELLS:
        vals = [_get(r, path) for r in runs]
        nums = [float(v) for v in vals if isinstance(v, (int, float)) and not isinstance(v, bool)]
        if not nums:
            continue
        med, spread = float(np.median(nums)), max(nums) - min(nums)
        rel = spread / abs(med) if med else float("nan")
        cells = " | ".join("-" if v is None else f"{v:.6g}" for v in vals)
        print(f"| {label} | {cells} | {med:.6g} | {spread:.4g} | {rel:.4g} |")
    print()
    for i, r in enumerate(runs):
        print(f"run {i + 1}: device {r.get('device')!r}, seed {r.get('seed')}, partial {r.get('partial')}, "
              f"torch {r.get('torch')}, CUDA {r.get('cuda')}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
