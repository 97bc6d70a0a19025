#!/usr/bin/env python3
"""Time the linear assignment kernel's design points on one NVIDIA card.

    python3 scripts/linear_variants.py

Each variant below is `csrc/linear_assign.cu` with one design point undone,
by the text substitutions listed with it (each must match the source
exactly once, or the script stops: the variants follow the shipped
source). Every variant is built into its own library under `_scratch/`
(gitignored), all at once. Two inputs at config 2's shape (100k x 64
binary rows, K = 32): rows around 32 well-separated Beta(0.5, 0.5)
profiles, where about one cluster a row lies within reach of the top score
(as on path B after a few sweeps), and path B's own inputs at its chain's
CRP start, where the clusters lie close together and several are within
reach. Each variant is checked draw for draw on both and on a ragged shape
(5013 x 300, K = 70) against the plain scores plus its own noise (four
draws a call: `linear_philox_scores`; one a call: the Gaussian kernels'
stream, `philox_gumbel`), then timed on both, in the order listed and then
reversed: warm (back to back, X in L2) and cold (each launch alone after a
64 MB write that evicts X from the 50 MB L2), each queued behind a spin
kernel, so that the events time the card and not the host's issue of the
launches. torch.addmm(base, X, W.T) is timed beside them as the library
yardstick. Also prints the noise each input needs (Philox calls and Gumbel
draws a row within reach of the top score, worked out in Python by
`noise_work`). Prints the card's name and power limit, then one JSON line.
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
from common_tpu_torch.ops import linear_assign as la  # noqa: E402

# the product on the CUDA cores: fp32 FMA over W's chunk in the stage
_FMA = """    for (int d = 0; d < 8 * steps; d += 2) {
      const float2 x0 = *reinterpret_cast<const float2*>(xs + wrow * kLd + d);
      const float2 x1 = *reinterpret_cast<const float2*>(xs + (wrow + 8) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 w = *reinterpret_cast<const float2*>(ws + (8 * j + 2 * t + e) * kLd + d);
          acc[j][e] = fmaf(x0.y, w.y, fmaf(x0.x, w.x, acc[j][e]));
          acc[j][2 + e] = fmaf(x1.y, w.y, fmaf(x1.x, w.x, acc[j][2 + e]));
        }
    }
"""
_STREAMED = ("{ return K <= kPanel && D <= kChunk; }", "{ return false; }")
_GRID = "const int blocks = fit * f.sms < n_tiles ? fit * f.sms : n_tiles;"
# a listed group's noise: one Philox call, its four words' logarithms side by side
_WORDS = """          const uint4 bits = philox::linear_words(seed, row, group);
          const float g0 = philox::gumbel_of_bits(bits.x), g1 = philox::gumbel_of_bits(bits.y);
          const float g2 = philox::gumbel_of_bits(bits.z), g3 = philox::gumbel_of_bits(bits.w);
"""
_DRAWS = """          draws[lane] = make_float4(words & 1u ? g0 : -INFINITY, words & 2u ? g1 : -INFINITY,
                                    words & 4u ? g2 : -INFINITY, words & 8u ? g3 : -INFINITY);
"""

# name: (substitutions, noise stream: "four" draws a call or "one");
# "shipped" is the source as it is
VARIANTS = {
    "shipped": ((), "four"),
    "cuda_cores": ((_STREAMED,
                    ("    if (resident) {\n      product(", _FMA + "    if (false) {\n      product("),
                    ("    } else {\n      const float* bw", "    } else if (false) {\n      const float* bw")),
                   "four"),
    "one_draw_a_call": (((_WORDS, """          const float g0 = philox::gumbel(seed, row, 4 * group), g1 = philox::gumbel(seed, row, 4 * group + 1);
          const float g2 = philox::gumbel(seed, row, 4 * group + 2), g3 = philox::gumbel(seed, row, 4 * group + 3);
"""),), "one"),
    "words_in_turn": (((_WORDS + _DRAWS, """          const uint4 bits = philox::linear_words(seed, row, group);
          float4 gum = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
          for (unsigned w = words; w; w &= w - 1u) {
            const int i = __ffs(w) - 1;
            const float gv = philox::gumbel_of_bits(i == 0 ? bits.x : i == 1 ? bits.y : i == 2 ? bits.z : bits.w);
            gum.x = i == 0 ? gv : gum.x;
            gum.y = i == 1 ? gv : gum.y;
            gum.z = i == 2 ? gv : gum.z;
            gum.w = i == 3 ? gv : gum.w;
          }
          draws[lane] = gum;
"""),), "four"),
    "no_pruning": ((("if (s[h][4 * q + i] >= floor_h) words |= 1u << i;", "words |= 1u << i;"),), "four"),
    "w_split_at_each_use": ((_STREAMED,), "four"),
    "three_stages": ((("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
                      ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")), "four"),
    "one_block_a_tile": (((_GRID, "const int blocks = n_tiles;"),), "four"),
    "one_block_a_sm": (((_GRID, "const int blocks = f.sms < n_tiles ? f.sms : n_tiles;"),), "four"),
}
N, D, K = 100_000, 64, 32
FLUSH_BYTES = 64 << 20
SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's clock


def variant_source(subs) -> str:
    src = (_build.CSRC / "linear_assign.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"linear_variants: {old!r} is not in csrc/linear_assign.cu exactly once")
        src = src.replace(old, new)
    return src


def build() -> dict:
    out_dir = ROOT / "_scratch" / "linear_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for name, (subs, _) in VARIANTS.items():
        src = out_dir / f"{name}.cu"
        src.write_text(variant_source(subs))
        libs[name] = src.with_suffix(".so")
        cmds.append([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler",
                     "-fPIC", "-shared", "-I", str(_build.CSRC), "-o", str(libs[name]), str(src)])
    for (rc, text), name in zip(_build._run_all(cmds), VARIANTS):
        print(f"{name}: {' '.join(line.strip() for line in text.splitlines() if 'registers' in line)}")
        if rc != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{text}")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, path in libs.items():
        libs[name] = ctypes.CDLL(str(path))
        libs[name].linear_assign_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    return libs


def problem(n, d, k, seed, dev):
    """Binary rows around k Beta(0.5, 0.5) profiles: X, W = logit p, base."""
    r = np.random.default_rng(seed)
    p = np.clip(r.beta(0.5, 0.5, size=(k, d)), 1e-3, 1 - 1e-3)
    X = (r.random((n, d)) < p[r.integers(0, k, n)]).astype(np.float32)
    W = np.log(p) - np.log1p(-p)
    base = np.log1p(-p).sum(-1) + np.log(r.dirichlet(np.ones(k)))
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in (X, W, base)]


def crp_start(dev):
    """Path B's inputs at its chain's start, as `chip_smoke.py` phase 5
    makes them: 100k x 64 binary rows around 8 planted Beta(0.5, 0.5)
    profiles (numpy seed 0), a CRP initial state with K_max = 32 (generator
    seed 3), and W, base drawn from it (generator seed 5). Its clusters lie
    close together, so a row has several within reach."""
    from common_tpu_torch import models, rng
    from common_tpu_torch import state as st
    from common_tpu_torch.kernels import blocked

    r = np.random.default_rng(0)
    probs = r.beta(0.5, 0.5, size=(8, D))
    rows = r.random((N + 4096, D)) < probs[r.integers(0, 8, N + 4096)]
    X = torch.tensor(rows[:N], dtype=torch.float32, device=dev)
    data = ((X, torch.ones(N, device=dev)),)
    hyper = {"alpha": np.ones(D, np.float32), "beta": np.ones(D, np.float32)}
    s0 = st.initialize(st.model_definition(N, [models.bbv(D)], k_max=K), data, rng(3, dev).generator,
                       cluster_hp={"alpha": 1.0}, feature_hps=[hyper])
    W, base, _ = blocked.linear_assign_inputs(s0, data, rng(5, dev).generator)
    return [X, W, base]


def queued_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` launched back to back, after one warm-up.

    The launches queue behind a spin kernel of about 10 ms, longer than the
    host takes to issue them, so the events time the card: a call of tens of
    microseconds costs the host about as long to issue as the card to run."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def cold_ms(fn, reps: int, flush) -> float:
    """Median milliseconds of one `fn()`, each launch timed by its own events
    after a write of `flush`, which evicts its inputs from L2, and a spin of
    about 0.5 ms, during which the host issues the launch."""
    fn()
    pairs = []
    for i in range(reps):
        flush.fill_(float(i))
        torch.cuda._sleep(SPIN_CYCLES // 20)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def mismatch(z, v) -> int:
    """Rows whose z is not the argmax of v, outside the fp32 tie band."""
    top2, arg = v.topk(2, dim=-1)
    tie = (top2[:, 0] - top2[:, 1]) <= 3e-5 * top2[:, 0].abs() + 1e-3
    return int(((z.long() != arg[:, 0]) & ~tie).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    device = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(name, X, W, base, seed):
        z = torch.empty(X.shape[0], dtype=torch.int32, device=dev)
        err = libs[name].linear_assign_launch(X.data_ptr(), W.data_ptr(), base.data_ptr(), seed.data_ptr(),
                                              z.data_ptr(), X.shape[0], X.shape[1], W.shape[0], device, stream)
        assert err == 0, err
        return z

    seed = torch.tensor([9], dtype=torch.int32, device=dev)
    sets = {"separated": problem(N, D, K, 0, dev), "crp_start": crp_start(dev)}
    checks = {**sets, "ragged": problem(5000 + 13, 300, 70, 5013, dev)}
    off = {}
    for case, (X, W, base) in checks.items():
        rows = torch.arange(X.shape[0], device=dev)
        noise = {"four": la.linear_philox_scores(X, W, base, seed),
                 "one": la.linear_scores(X, W, base) + ga.philox_gumbel(seed, rows, W.shape[0])}
        off[case] = {name: mismatch(launch(name, X, W, base, seed), noise[stream_of])
                     for name, (_, stream_of) in VARIANTS.items()}
    print(f"rows off the plain draw outside the tie band: {off}", flush=True)

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    result = {}
    for case, (X, W, base) in sets.items():
        need = la.noise_work(X, W, base)
        print(f"{case}: noise within reach of the panel's top score, worked out in Python: "
              f"{need['calls']:.4f} Philox calls of {-(-K // 4)} and {need['draws']:.4f} draws of {K} a row, "
              f"{need['single']:.4f} of the rows with a single cluster within reach", flush=True)
        fns = {name: (lambda name=name: launch(name, X, W, base, seed)) for name in VARIANTS}
        fns["torch.addmm"] = lambda: torch.addmm(base, X, W.T)
        warm = {name: [] for name in fns}
        cold = {name: [] for name in fns}
        order = list(fns)
        for name in order + order[::-1]:
            warm[name].append(queued_ms(fns[name], 50))
            cold[name].append(cold_ms(fns[name], 30, flush))
        for name in fns:
            print(f"  {name}: warm {[round(m, 5) for m in warm[name]]} ms, "
                  f"cold {[round(m, 5) for m in cold[name]]} ms", flush=True)
        result[case] = {"noise_need": need, "warm_ms": warm, "cold_ms": cold}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "mismatch": off, **result}))
    return 0 if not any(v for case in off.values() for v in case.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
