#!/usr/bin/env python3
"""Time the Gaussian assignment kernel under several tilings on one NVIDIA card.

    python3 scripts/assign_tilings.py

`csrc/gaussian_assign.cu` picks one of two tilings by D. This script
builds, into `_scratch/` (gitignored), a library that includes that source
and launches its kernel template under each tiling below, (input panel
depth, stages, outputs per warp), checks each draw for draw against the
plain scores plus the kernel's noise at 16421 x 256, K = 64, and times each
at the main path's shape (1M x 256 rows around 8 planted centers, K = 64)
in the order listed and then reversed. Each panel costs one barrier of all
8 warps, so deeper panels and wider warp tiles trade shared memory for
fewer barriers; the time against 1 / panel depth extrapolates the loop's
steady state. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from common_tpu_torch.ops import _build  # noqa: E402
from common_tpu_torch.ops import gaussian_assign as ga  # noqa: E402

# (panel depth, stages, outputs per warp); the first is the kernel's wide tiling
TILINGS = [(32, 2, 64), (16, 3, 64), (16, 2, 32), (32, 2, 32), (64, 2, 32)]
N, D, K = 1_000_000, 256, 64


def build():
    src = ROOT / "_scratch" / "assign_tilings.cu"
    src.parent.mkdir(exist_ok=True)
    cases = "\n".join(
        f"    case {i}: return launch_tiling<false, {p}, {s}, {w}>(X, mu, binv, base, seed, z, N, D, K, 1, 0, st);"
        for i, (p, s, w) in enumerate(TILINGS))
    src.write_text(f'''#include "{ROOT / "common_tpu_torch/csrc/gaussian_assign.cu"}"
extern "C" int tiling_launch(int id, const float* X, const float* mu, const float* binv, const float* base,
                             const int* seed, int* z, int N, int D, int K, void* st) {{
  switch (id) {{
{cases}
  }}
  return -1;
}}
''')
    out = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-I", str(_build.CSRC), "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tiling_launch.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    return lib


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    def launch(i, X, mu, binv, base, seed):
        z = torch.empty(X.shape[0], dtype=torch.int32, device=dev)
        err = lib.tiling_launch(i, X.data_ptr(), mu.data_ptr(), binv.data_ptr(), base.data_ptr(), seed.data_ptr(),
                                z.data_ptr(), X.shape[0], X.shape[1], mu.shape[0],
                                torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return z

    # draw for draw on clusters told apart by B_k alone
    r = np.random.default_rng(6)
    n = 16421
    Xs = torch.tensor(r.normal(size=(n, D)), dtype=torch.float32, device=dev)
    mus = torch.tensor(r.normal(scale=0.3, size=(K, D)), dtype=torch.float32, device=dev)
    bs = torch.tensor(np.tril(r.normal(scale=D ** -0.5, size=(K, D, D)), -1)
                      + np.eye(D) * r.uniform(0.5, 1.5, (K, 1, D)), dtype=torch.float32, device=dev)
    bases = torch.tensor(r.normal(size=K), dtype=torch.float32, device=dev)
    seed = torch.tensor([21], dtype=torch.int32, device=dev)
    v = ga.philox_scores(Xs, mus, bs, bases, seed)
    top2, arg = v.topk(2, dim=-1)
    tie = (top2[:, 0] - top2[:, 1]) <= 3e-5 * top2[:, 0].abs() + 1e-3
    mismatch = {str(t): int(((launch(i, Xs, mus, bs, bases, seed).long() != arg[:, 0]) & ~tie).sum())
                for i, t in enumerate(TILINGS)}
    print(f"rows off the plain draw outside the tie band: {mismatch}", flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    centers = 4.0 * torch.randn(8, D, generator=g, device=dev)
    x = centers[torch.randint(0, 8, (N,), generator=g, device=dev)] + torch.randn(N, D, generator=g, device=dev)
    mu = (centers.repeat(K // 8, 1) + 0.1 * torch.randn(K, D, generator=g, device=dev)).contiguous()
    a = torch.randn(K, D, D, generator=g, device=dev) / D ** 0.5
    binv = torch.linalg.inv(torch.linalg.cholesky(a @ a.transpose(1, 2) + torch.eye(D, device=dev))).contiguous()
    base = torch.randn(K, generator=g, device=dev)
    times = {str(t): [] for t in TILINGS}
    order = list(range(len(TILINGS)))
    for i in order + order[::-1]:
        times[str(TILINGS[i])].append(cuda_ms(lambda: launch(i, x, mu, binv, base, seed), 2))
    for t, ms in times.items():
        print(f"tiling (panel, stages, outputs per warp) {t}: {[round(m, 2) for m in ms]} ms", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "mismatch": mismatch, "ms": times}))
    return 0 if not any(mismatch.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
