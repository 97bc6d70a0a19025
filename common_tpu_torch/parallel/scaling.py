"""Row-scaling measurement of the data-sharded sweep (port of
`common_tpu/parallel/scaling.py`).

`measure_row_scaling` times the data-sharded blocked sweep
(`parallel/sharded.py`) at a ladder of shard counts and reports

  throughput[s]  sweeps/s with the rows split s ways
  efficiency     (throughput[max] / throughput[min]) / (max / min)

A rung of s shards runs in s processes, which the harness spawns itself
(`mesh.spawn`: `torch.multiprocessing`'s spawn method) and joins over a
`FileStore` in a
temporary directory; rank r runs on `devices[r]`, over the backend the
caller names. On several cards over "nccl" this is the scaling
measurement; with ranks that share one card, or CPU processes, over
"gloo", the ranks share the hardware, so the numbers are a plumbing and
collective-overhead check, not a hardware claim.

Each rung builds the problem on every rank from one seed (CPU generator),
runs one untimed sweep, then `repeats` timed runs of `sweeps` sweeps: CUDA
events on a card, the host clock on the CPU, each run's time the slowest
rank's (an all_reduce of the max). The median is reported with its spread.
A failed rank fails the call.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from common_tpu_torch import models
from common_tpu_torch import state as state_mod
from common_tpu_torch import validator
from common_tpu_torch.parallel import mesh as mesh_mod
from common_tpu_torch.parallel import sharded


def _make_problem(n, d, k_max, seed):
    """8 planted centers at scale 4 plus unit noise, made on the CPU."""
    g = torch.Generator().manual_seed(seed)
    defn = state_mod.model_definition(n, [models.niw(d)], k_max=k_max)
    centers = 4.0 * torch.randn(8, d, generator=g)
    z = torch.randint(0, 8, (n,), generator=g)
    x = centers[z] + torch.randn(n, d, generator=g)
    return defn, ((x, torch.ones(n)),)


def _rung(rank, world, store, out, backend, devices, n, d, k_max, sweeps, repeats, seed):
    """One rank of a rung: time `repeats` runs of `sweeps` sharded sweeps."""
    torch.set_num_threads(1)
    mesh_mod.init_distributed(backend, init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        mesh = mesh_mod.make_mesh(1, world, backend=backend, device=devices[rank])
        dev = mesh.device
        defn, data = _make_problem(n, d, k_max, seed)
        states = sharded.initialize_chains(
            defn, data, [torch.Generator().manual_seed(seed + 1)], cluster_hp={"alpha": 1.0})
        states, local = mesh_mod.shard_state(mesh, states, data)
        sweep = sharded.make_sharded_sweep(mesh, states, local)
        gens = sharded.chain_generators(mesh, seed + 2, 1)

        def run(st):
            for _ in range(sweeps):
                st = sweep(st, local, gens)
            return st

        states = run(states)  # warm-up: the kernels' set-up and the collectives' first calls
        times = []
        for _ in range(repeats):
            dist.barrier()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                states = run(states)
                end.record()
                end.synchronize()
                sec = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                states = run(states)
                sec = time.perf_counter() - t0
            slowest = torch.tensor([sec], dtype=torch.float64, device=dev)
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
            times.append(float(slowest))
        if rank == 0:  # the counts are global: all-reduced over the data ranks every sweep
            with open(out, "w") as f:
                json.dump({"times": times, "rows_counted": int(states.counts.sum())}, f)
    finally:
        dist.destroy_process_group()


def measure_row_scaling(
    n: int = 65536,
    d: int = 16,
    k_max: int = 16,
    sweeps: int = 8,
    shard_counts: Sequence[int] = (1, 2, 4, 8),
    devices: Sequence = None,
    backend: str = None,
    seed: int = 0,
    repeats: int = 3,
    timeout_s: float = 600.0,
) -> Dict:
    """Sweeps/s of the data-sharded blocked sweep at each shard count.

    devices: rank r of a rung runs on devices[r] (at least max(shard_counts)
    of them; repeat a device for ranks that share it). backend: "nccl" or
    "gloo", named by the caller. n is rounded up to divide over every
    shard count. A rung still running after timeout_s seconds is killed
    and raises. Returns {"throughput": {s: median sweeps/s}, "spread":
    {s: (max - min) / median over the repeats}, "efficiency",
    "collectives_ok", "shard_counts", "n", "d", "k_max", "sweeps",
    "repeats", "backend", "devices"}.
    """
    validator.validate_nonempty(shard_counts, "shard_counts")
    validator.validate_one_of(backend, mesh_mod.BACKENDS, "backend")
    shard_counts = sorted(int(s) for s in shard_counts)
    if devices is None or len(devices) < shard_counts[-1]:
        raise ValueError(f"need {shard_counts[-1]} devices (one a rank), got {devices}")
    devices = [str(torch.device(v)) for v in devices]
    lcm = int(np.lcm.reduce(shard_counts))
    n = -(-n // lcm) * lcm

    throughput, spread, counted = {}, {}, {}
    for s in shard_counts:
        with tempfile.TemporaryDirectory() as tmp:
            store, out = os.path.join(tmp, "store"), os.path.join(tmp, "rung.json")
            mesh_mod.spawn(_rung, (s, store, out, backend, devices[:s], n, d, k_max, sweeps, repeats, seed),
                           s, timeout_s)
            with open(out) as f:
                res = json.load(f)
        times = res["times"]
        med = float(np.median(times))
        throughput[s] = sweeps / med
        spread[s] = (max(times) - min(times)) / med
        counted[s] = res["rows_counted"]

    lo, hi = shard_counts[0], shard_counts[-1]
    efficiency = (throughput[hi] / throughput[lo]) / (hi / lo)
    return {
        "throughput": throughput,
        "spread": spread,
        "efficiency": float(efficiency),
        # every rung ran its collectives, counted every row once, and gave a
        # finite positive rate; on ranks that share hardware this and the
        # raw rates are the result, and `efficiency` is no hardware claim
        "collectives_ok": bool(all(np.isfinite(v) and v > 0 for v in throughput.values())
                               and all(c == n for c in counted.values())),
        "shard_counts": shard_counts,
        "n": n,
        "d": d,
        "k_max": k_max,
        "sweeps": sweeps,
        "repeats": repeats,
        "backend": backend,
        "devices": devices[:hi],
    }
