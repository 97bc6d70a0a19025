"""Helpers of the benchmark's own tests: tiny copies of the cells for the CPU."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import run

TINY = {"niw": {"n": 3000, "d": 8, "k_max": 8}, "bbv": {"n": 3000, "d": 16, "k_max": 8}}
TINY_TRAFFIC = {"smc_blocked": {"block": 256, "warmup_rows": 32, "trace_blocks": 2}}


def tiny_spec(cell: str, n: int | None = None):
    """The cell's spec with its configuration (and its blocks) cut to a CPU test's size."""
    spec = copy.deepcopy(run.cell_spec(cell))
    cfg = spec.config
    cfg.update(TINY[cfg["model"]])
    spec.workload.update(TINY_TRAFFIC.get(spec.workload["driver"], {}))
    if n is not None:
        cfg["n"] = n
    if cfg["model"] == "niw":
        cfg["hyper"]["nu"] = cfg["d"] + 2.0
    return spec


@pytest.fixture
def card():
    """The first CUDA device; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
