#!/usr/bin/env python3
"""Time this tree's assignment and scatter kernels against an earlier tree's,
in turns, on one NVIDIA card.

    mkdir -p _scratch/parent
    git archive <commit> common_tpu_torch/csrc | tar -x -C _scratch/parent
    python3 scripts/kernel_turns.py _scratch/parent/common_tpu_torch/csrc

The earlier sources are built with nvcc into `_scratch/` (gitignored), this
tree's through the package. At the main path's shape (1M x 256 rows around
8 planted centers, K = 64 slots; C = 4 chains for the chain form) each
kernel runs in the order earlier, this, this, earlier, and the mean of
each pair is reported:

- kernel 1, `gaussian_assign_launch` (with or without the row_offset
  argument that later sources take), and kernel 4,
  `gaussian_assign_chains_launch`: the same C entry points in both trees;
  the two trees' draws are compared row for row;
- kernel 2, the scatter: each tree's kernels alone on rows already sorted
  by cluster, and each whole call with its stable sort, both trees with
  this tree's chunk schedule (the earlier tree must have this tree's C
  interface). The labels put 3 of the 8
  planted groups in one cluster (375k rows), as the main path's largest
  cluster holds about a third of the rows;
- kernel 3, `linear_assign_launch`, at config 2's shape (100k x 64 binary
  rows, K = 32) on the two inputs of `scripts/linear_variants.py` (rows
  around 32 well-separated profiles, and path B's CRP start), warm and
  L2-cold, timed as that script times it (queued behind a spin kernel;
  cold after a 64 MB write); each tree's draws are checked against the
  plain scores plus its own noise stream.

Prints the card's name and power limit, then one JSON line. Needs a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from common_tpu_torch.ops import _build  # noqa: E402
from common_tpu_torch.ops import gaussian_assign as ga  # noqa: E402
from common_tpu_torch.ops import linear_assign as la  # noqa: E402
from common_tpu_torch.ops import suffstat as ss  # noqa: E402
from linear_variants import FLUSH_BYTES, cold_ms, crp_start, mismatch, problem, queued_ms  # noqa: E402

N, D, K, C = 1_000_000, 256, 64, 4
N3, D3, K3 = 100_000, 64, 32  # kernel 3: config 2
OLD_ROW_OFFSET = False  # whether the earlier tree's kernel 1 takes a row_offset (set by build_old)


def build_old(csrc: Path):
    out = Path("_scratch") / "kernel_turns_old.so"
    out.parent.mkdir(exist_ok=True)
    srcs = [str(csrc / "gaussian_assign.cu"), str(csrc / "suffstat.cu"), str(csrc / "linear_assign.cu")]
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
           "-I", str(csrc), "-o", str(out), *srcs]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out.resolve()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    global OLD_ROW_OFFSET
    # kernel 1's C entry point gained its row_offset argument in this tree's sources
    OLD_ROW_OFFSET = "row_offset" in (csrc / "gaussian_assign.cu").read_text()
    lib.gaussian_assign_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci] + [ci] * OLD_ROW_OFFSET + [vp]
    lib.gaussian_assign_chains_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.scatter_stats_launch.argtypes = [vp] * 7 + [ci, ci, ci, vp]
    lib.linear_assign_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
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


def in_turns(old_fn, new_fn, reps: int, timer=cuda_ms) -> dict:
    t = [timer(f, reps) for f in (old_fn, new_fn, new_fn, old_fn)]
    return {"old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2, "turns_ms": t}


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    old = build_old(Path(sys.argv[1]))
    _build.library()
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    g = torch.Generator(device=dev).manual_seed(0)
    centers = 4.0 * torch.randn(8, D, generator=g, device=dev)
    labels = torch.randint(0, 8, (N,), generator=g, device=dev)
    x = centers[labels] + torch.randn(N, D, generator=g, device=dev)
    slots = C * K
    mu = (centers.repeat(slots // 8, 1) + 0.1 * torch.randn(slots, D, generator=g, device=dev)).contiguous()
    a = torch.randn(slots, D, D, generator=g, device=dev) / D ** 0.5
    binv = torch.linalg.inv(torch.linalg.cholesky(a @ a.transpose(1, 2) + torch.eye(D, device=dev))).contiguous()
    base = torch.randn(slots, generator=g, device=dev)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)

    def old_assign(n_chains):
        z = torch.empty((n_chains, N), dtype=torch.int32, device=dev)
        if n_chains == 1:
            args = (x.data_ptr(), mu.data_ptr(), binv.data_ptr(), base.data_ptr(), seed.data_ptr(), z.data_ptr(),
                    N, D, K) + ((0,) if OLD_ROW_OFFSET else ()) + (stream,)
            err = old.gaussian_assign_launch(*args)
        else:
            err = old.gaussian_assign_chains_launch(x.data_ptr(), mu.data_ptr(), binv.data_ptr(),
                                                    base.data_ptr(), seed.data_ptr(), z.data_ptr(), N, D, K,
                                                    n_chains, stream)
        assert err == 0, err
        return z

    mu1, binv1, base1 = mu[:K], binv[:K], base[:K]
    result = {}
    k1 = in_turns(lambda: old_assign(1), lambda: ga.fused_gaussian_assign(x, mu1, binv1, base1, seed), 2)
    k1["rows_differ"] = int((old_assign(1)[0] != ga.fused_gaussian_assign(x, mu1, binv1, base1, seed)).sum())
    result["gaussian_assign"] = k1
    k4 = in_turns(lambda: old_assign(C), lambda: ga.fused_gaussian_assign_chains(x, mu, binv, base, seed, C), 1)
    k4["rows_differ"] = int((old_assign(C) != ga.fused_gaussian_assign_chains(x, mu, binv, base, seed, C)).sum())
    result["gaussian_assign_chains"] = k4
    print(f"kernel 1: {k1}\nkernel 4: {k4}", flush=True)

    z = torch.where(labels < 3, 0, labels).to(torch.int32)
    order, offsets = ss.sort_by_cluster(z, K)

    def old_kernel(o=order, off=offsets):
        cstart, lo, hi = ss.chunk_schedule(off, N, ss.rows_per_chunk(N, D, K))
        partial = torch.empty((lo.numel(), D, D), device=dev)
        out = torch.empty((K, D, D), device=dev)
        err = old.scatter_stats_launch(x.data_ptr(), o.data_ptr(), lo.data_ptr(), hi.data_ptr(), cstart.data_ptr(),
                                       partial.data_ptr(), out.data_ptr(), D, K, lo.numel(), stream)
        assert err == 0, err
        return out

    def old_wrapper():
        return old_kernel(*ss.sort_by_cluster(z, K))

    k2 = in_turns(old_kernel, lambda: ss.scatter_sorted(x, order, offsets), 5)
    k2w = in_turns(old_wrapper, lambda: ss.fused_scatter_stats(x, z, K), 5)
    k2["old_wrapper_ms"], k2["new_wrapper_ms"] = k2w["old_ms"], k2w["new_ms"]
    k2["sort_ms"] = cuda_ms(lambda: ss.sort_by_cluster(z, K), 5)
    new = ss.scatter_sorted(x, order, offsets)
    k2["max_abs_diff"] = (new - old_kernel()).abs().max().item()
    k2["max_abs"] = new.abs().max().item()
    result["scatter_stats"] = k2
    print(f"kernel 2: {k2}", flush=True)

    # kernel 3 at config 2's shape, on well-separated rows and on path B's CRP start
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    for case, (X3, W3, base3) in (("separated", problem(N3, D3, K3, 0, dev)), ("crp_start", crp_start(dev))):

        def old_linear(X3=X3, W3=W3, base3=base3):
            z3 = torch.empty(N3, dtype=torch.int32, device=dev)
            err = old.linear_assign_launch(X3.data_ptr(), W3.data_ptr(), base3.data_ptr(), seed.data_ptr(),
                                           z3.data_ptr(), N3, D3, K3, stream)
            assert err == 0, err
            return z3

        def new_linear(X3=X3, W3=W3, base3=base3):
            return la.fused_linear_assign(X3, W3, base3, seed)

        k3 = in_turns(old_linear, new_linear, 50, queued_ms)
        k3_cold = in_turns(old_linear, new_linear, 30, lambda f, reps: cold_ms(f, reps, flush))
        k3.update({f"{key}_cold": v for key, v in k3_cold.items()})
        scores = la.linear_scores(X3, W3, base3)
        rows = torch.arange(N3, device=dev)
        k3["old_mismatch"] = mismatch(old_linear(), scores + ga.philox_gumbel(seed, rows, K3))
        k3["new_mismatch"] = mismatch(new_linear(), scores + la.linear_philox_gumbel(seed, rows, K3))
        result[f"linear_assign_{case}"] = k3
        print(f"kernel 3, {case}: {k3}", flush=True)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
