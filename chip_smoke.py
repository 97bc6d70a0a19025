#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`common_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. Environment: the card's name and power limit (nvidia-smi), and the
   build of the CUDA kernels from `common_tpu_torch/csrc/`.
2. Each kernel against its plain PyTorch version on the card:
   assignment on well-separated clusters (n=16421, D=256, K=64, dense
   triangular B_k) against the plain sampler, and draw for draw against
   the plain scores plus the kernel's own Philox noise, there and on
   clusters told apart by B_k alone; its sampling distribution (n=64, D=4,
   K=5, 300 seeds); scatter stats at 1M x 256, K=64 with masked rows and a
   ragged N, and at a small shape against float64 on the host.
3. The main path at 1M x 256, K_max=64: model_definition -> initialize
   (CRP) -> runner(..., [("assign_blocked_fused", {})]); one first sweep,
   timed apart because it carries the one-time CUDA library set-up, then
   .run(gen, 10) with the kernels' launch counts set to 0 just before.
   4096 held-out rows. Checks finite scores, counts, kernel launch counts,
   the stats against the plain restat, k_active and the held-out log
   density; checks the assignment kernel draw for draw on the main path's
   own inputs; times fused and plain sweeps and each kernel against its
   plain version on those inputs; traces one more sweep for device time by
   kernel and the device's idle share.

In the `kernels` line, `max_abs_err` of scatter_stats is max|kernel - plain|
on the main path's z. The assignment kernel returns labels, so its
`max_abs_err` is the largest shortfall, in nats, of the perturbed score of
the kernel's choice below the plain maximum (0 where they agree, at most
the fp32 tie band on a tie), with `mismatch` the rows outside the tie band
that differ and `tie_rows` the rows inside it, over the main path's 1M rows.

The line before the last is the card's name and power limit; the last is
{"ok": true, "device": {...}}. Needs a CUDA card: without one it exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
N, D, K_MAX, HELDOUT = 1_000_000, 256, 64, 4096
N_SWEEPS = 10


class SmokeFailure(Exception):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` on the current stream, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_sweep(run, gen) -> None:
    """Device time by kernel, and the idle share, over one traced runner sweep."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run(gen, 1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    log(f"traced runner sweep: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall_ms:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {ms:9.3f} ms  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def phase_environment() -> dict:
    import torch

    from common_tpu_torch.ops import _build

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    line = card_line()
    log(f"card: {line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    for path in sorted(_build.BUILD_DIR.glob("*.log")):
        for ln in path.read_text().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                log(f"  ptxas: {ln.strip()}")
    return {"card": line}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def _dense_binv(r, k, d, diag_lo, diag_hi):
    """[k, d, d] random lower-triangular B_k: dense below the diagonal."""
    off = np.tril(r.normal(scale=d ** -0.5, size=(k, d, d)), -1)
    return (off + np.eye(d) * r.uniform(diag_lo, diag_hi, size=(k, 1, d))).astype(np.float32)


def _assign_problem(n, d, k, sep, seed, device):
    """Rows around k centers `sep` apart, a dense triangular B_k per cluster."""
    import torch

    r = np.random.default_rng(seed)
    mu = r.normal(scale=sep, size=(k, d)).astype(np.float32)
    X = (mu[r.integers(0, k, n)] + r.normal(scale=0.5, size=(n, d))).astype(np.float32)
    binv = _dense_binv(r, k, d, 1.5, 2.5)
    base = np.zeros(k, np.float32)
    return [torch.from_numpy(a).to(device) for a in (X, mu, binv, base)]


def _covariance_problem(n, d, k, seed, device):
    """Clusters that differ mostly in B_k: every row's draw hangs on all of B_k."""
    import torch

    r = np.random.default_rng(seed)
    mu = r.normal(scale=0.3, size=(k, d)).astype(np.float32)
    X = r.normal(size=(n, d)).astype(np.float32)
    binv = _dense_binv(r, k, d, 0.5, 1.5)
    base = r.normal(size=k).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (X, mu, binv, base)]


def _seed(value: int, device):
    import torch

    return torch.tensor([value], dtype=torch.int32, device=device)


def assign_exact_check(z, X, mu, binv, base, seed, rtol=3e-5, chunk=1 << 17) -> dict:
    """The kernel's z against the argmax of the plain scores plus the kernel's
    own Philox noise (`philox_scores`), row for row.

    A row whose top two perturbed scores lie within rtol * |top| + 1e-3 of
    each other is an fp32 tie and may go either way; every other row must
    agree. `shortfall` is max_n (max_k v_nk - v_n,z_n) in nats: how far the
    perturbed score of the kernel's choice lies below the plain maximum.
    """
    import torch

    from common_tpu_torch.ops.gaussian_assign import philox_scores

    ties = mismatch = 0
    shortfall = 0.0
    for a in range(0, X.shape[0], chunk):
        v = philox_scores(X[a:a + chunk], mu, binv, base, seed, row0=a)
        top2, arg = v.topk(2, dim=-1)
        tie = (top2[:, 0] - top2[:, 1]) <= rtol * top2[:, 0].abs() + 1e-3
        zc = z[a:a + chunk].long()
        ties += int(tie.sum())
        mismatch += int(((zc != arg[:, 0]) & ~tie).sum())
        off = top2[:, 0] - v.gather(1, zc[:, None])[:, 0]
        shortfall = max(shortfall, float(off.max()))
    torch.cuda.synchronize()
    return {"rows": int(X.shape[0]), "ties": ties, "mismatch": mismatch, "shortfall": shortfall}


def require_exact(check: dict, what: str) -> None:
    log(f"{what}: {check['mismatch']} of {check['rows']} rows differ from the plain "
        f"argmax with the kernel's noise outside the fp32 tie band (bar 0); "
        f"{check['ties']} tie rows (bar <= 1%); max shortfall {check['shortfall']:.3e} nats")
    require(check["mismatch"] == 0, f"{what}: assignment kernel disagrees with its plain version")
    require(check["ties"] <= 0.01 * check["rows"], f"{what}: too many fp32 ties")


def phase_kernels() -> dict:
    import torch

    from common_tpu_torch.ops.gaussian_assign import fused_gaussian_assign, gaussian_assign_plain
    from common_tpu_torch.ops.suffstat import fused_scatter_stats, scatter_stats_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    # assignment, well separated (ragged N, dense triangular B_k): both
    # samplers are near-deterministic
    n_sep = 16384 + 37
    X, mu, binv, base = _assign_problem(n_sep, 256, 64, 6.0, 5, dev)
    z = fused_gaussian_assign(X, mu, binv, base, _seed(13, dev))
    zp = gaussian_assign_plain(X, mu, binv, base, g)
    torch.cuda.synchronize()
    agree = (z == zp).double().mean().item()
    out["assign_agree"] = agree
    log(f"assign n={n_sep} D=256 K=64 sep=6: agreement {agree:.6f} (bar > 0.99)")
    require(agree > 0.99, f"assignment agreement {agree} <= 0.99")
    require_exact(assign_exact_check(z, X, mu, binv, base, _seed(13, dev)),
                  f"assign n={n_sep} D=256 K=64 sep=6, draw for draw")

    # clusters told apart by B_k alone: the draw of most rows changes if any
    # part of B_k is read wrongly (shown by dropping its off-diagonal part)
    X, mu, binv, base = _covariance_problem(n_sep, 256, 64, 6, dev)
    seed = _seed(21, dev)
    z = fused_gaussian_assign(X, mu, binv, base, seed)
    require_exact(assign_exact_check(z, X, mu, binv, base, seed),
                  f"assign n={n_sep} D=256 K=64 by covariance, draw for draw")
    diag = torch.diag_embed(torch.diagonal(binv, dim1=-2, dim2=-1)).contiguous()
    moved = (fused_gaussian_assign(X, mu, diag, base, seed) != z).double().mean().item()
    log(f"  share of draws that change when B_k loses its off-diagonal part: "
        f"{moved:.4f} (bar > 0.5)")
    require(moved > 0.5, "the covariance check does not depend on B_k's off-diagonal part")

    # assignment distribution: per-row frequencies against the softmax
    d, k, n, reps = 4, 5, 64, 300
    r = np.random.default_rng(1)
    mu_s = torch.tensor(r.normal(scale=0.8, size=(k, d)), dtype=torch.float32, device=dev)
    X_s = torch.tensor(r.normal(scale=1.0, size=(n, d)), dtype=torch.float32, device=dev)
    binv_s = torch.eye(d, device=dev).expand(k, d, d).contiguous()
    base_s = torch.tensor(r.normal(size=k), dtype=torch.float32, device=dev)
    diff = X_s[:, None, :] - mu_s[None]
    probs = torch.softmax(base_s[None, :] - 0.5 * (diff * diff).sum(-1), dim=-1).cpu().numpy()
    zs = torch.stack([
        fused_gaussian_assign(X_s, mu_s, binv_s, base_s, _seed(100 + i, dev)) for i in range(reps)
    ]).cpu().numpy()
    counts = np.zeros((n, k))
    for zi in zs:
        counts[np.arange(n), zi] += 1
    freq = counts / reps
    max_gap = float(np.abs(freq - probs).max())
    mean_gap = float(np.abs(freq.mean(0) - probs.mean(0)).max())
    log(f"assign distribution n=64 D=4 K=5 x{reps} seeds: max gap {max_gap:.4f} "
        f"(bar < 0.15), mean gap {mean_gap:.4f} (bar < 0.03)")
    require(max_gap < 0.15 and mean_gap < 0.03, "assignment distribution off")

    # scatter stats at the main path's size, masked rows and a ragged N
    n_big = N + 37
    r = np.random.default_rng(3)
    Xb = torch.randn((n_big, D), generator=g, device=dev)
    zb = torch.tensor(r.integers(-1, K_MAX + 1, n_big), dtype=torch.int32, device=dev)
    got = fused_scatter_stats(Xb, zb, K_MAX)
    want = scatter_stats_plain(Xb, zb, K_MAX)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"scatter N={n_big} D={D} K={K_MAX}: max|kernel - plain| {err:.3e}, "
        f"bar 1e-4 * {scale:.3e}")
    require(err <= 1e-4 * scale, "scatter stats disagree at full size")
    del Xb, zb, got, want

    # scatter stats at a small shape against float64 on the host
    r = np.random.default_rng(4)
    Xs = r.normal(size=(1000, 20)).astype(np.float32)
    zsm = r.integers(-1, 8, 1000).astype(np.int32)  # -1 and 7 = K: dropped
    got = fused_scatter_stats(torch.from_numpy(Xs).to(dev), torch.from_numpy(zsm).to(dev), 7)
    X64 = Xs.astype(np.float64)
    want = np.stack([X64[zsm == c].T @ X64[zsm == c] for c in range(7)])
    err = float(np.abs(got.cpu().numpy() - want).max())
    log(f"scatter N=1000 D=20 K=7 vs float64: max abs err {err:.3e} "
        f"(bar 1e-5 * {np.abs(want).max():.3e})")
    require(err <= 1e-5 * np.abs(want).max(), "scatter stats disagree with float64")
    return out


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
def phase_main_path(kernel_checks: dict) -> dict:
    import torch

    from common_tpu_torch import models, rng, state as st
    from common_tpu_torch.kernels import blocked
    from common_tpu_torch.ops import gaussian_assign as ga
    from common_tpu_torch.ops import suffstat as ss
    from common_tpu_torch.runner import runner

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    # 8 planted centers at scale 4 plus unit noise (bench.py make_data_device)
    r = np.random.default_rng(SEED)
    centers = 4.0 * r.standard_normal((8, D), dtype=np.float32)
    X_all = centers[r.integers(0, 8, N + HELDOUT)]
    X_all += r.standard_normal((N + HELDOUT, D), dtype=np.float32)
    x = torch.from_numpy(X_all[:N]).to(dev)
    xh = torch.from_numpy(X_all[N:]).to(dev)
    del X_all
    mask = torch.ones(N, device=dev)
    data = ((x, mask),)
    torch.cuda.synchronize()
    log(f"data {N}x{D} + {HELDOUT} held out: {time.perf_counter() - t0:.2f} s (host numpy)")

    hyper = {"mu0": np.zeros(D, np.float32), "kappa": 1.0,
             "psi": np.eye(D, dtype=np.float32), "nu": float(D + 2)}
    defn = st.model_definition(N, [models.niw(D)], k_max=K_MAX)
    gen = rng(SEED, dev).generator
    t0 = time.perf_counter()
    s0 = st.initialize(defn, data, gen, cluster_hp={"alpha": 1.0}, feature_hps=[hyper])
    torch.cuda.synchronize()
    log(f"initialize (CRP draw on the host + stats): {time.perf_counter() - t0:.2f} s, "
        f"k_active {int((s0.counts > 0).sum())}")
    t0 = time.perf_counter()
    st.sample_crp_assignment(rng(SEED + 1, dev).generator, N, K_MAX, torch.tensor(1.0))
    log(f"  of which the CRP host loop alone: {time.perf_counter() - t0:.2f} s")

    run = runner(defn, data, s0, [("assign_blocked_fused", {})])
    t0 = time.perf_counter()
    run.run(gen, 1)
    torch.cuda.synchronize()
    log(f"first fused sweep, with one-time CUDA library set-up: {time.perf_counter() - t0:.2f} s")
    ga.fused_gaussian_assign.launches = 0
    ss.fused_scatter_stats.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.run(gen, N_SWEEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"gaussian_assign": ga.fused_gaussian_assign.launches,
                "suffstat": ss.fused_scatter_stats.launches}
    log(f"runner.run({N_SWEEPS} fused sweeps): {run_s:.3f} s, "
        f"{N_SWEEPS / run_s:.3f} sweeps/s (with the score trace); launches {launches}")
    require(all(v == N_SWEEPS for v in launches.values()),
            f"kernel launches {launches} != {N_SWEEPS} sweeps")

    scores = run.score_trace[1:]
    k_active = run.k_active_trace[1:]
    log(f"score_joint trace: {scores.tolist()}")
    log(f"k_active trace: {k_active.tolist()}")
    require(np.isfinite(scores).all(), "non-finite score_joint")
    require(int(k_active[-1]) >= 2, f"k_active {k_active[-1]} < 2")
    s = run.get_latent()
    require(int(s.counts.sum()) == N, "counts do not sum to N")

    plain = blocked.restat(s, data, s.assignments)
    for leaf in ("n", "sum_x", "sum_xxT"):
        a, b = s.stats[0][leaf], plain.stats[0][leaf]
        err = (a - b).abs().max().item()
        bar = 1e-4 * b.abs().max().item()
        log(f"final stats {leaf}: max|fused - plain restat| {err:.3e} (bar {bar:.3e})")
        require(err <= bar, f"final {leaf} disagrees with the plain restat")
    require(torch.equal(s.counts, plain.counts), "counts disagree with the plain restat")

    t0 = time.perf_counter()
    lp = st.heldout_logp(s, ((xh, torch.ones(HELDOUT, device=dev)),))
    lp_dim = lp.mean().item() / D
    log(f"held-out logp/dim ({HELDOUT} rows): {lp_dim:.5f} "
        f"({time.perf_counter() - t0:.2f} s)")
    require(np.isfinite(lp_dim), "held-out logp is not finite")

    # whole sweeps, in turns: fused, plain, plain, fused, fused, plain
    times = {"fused": [], "plain": []}
    for kind in ("fused", "plain", "plain", "fused", "fused", "plain"):
        fn = blocked.sweep_fused if kind == "fused" else blocked.sweep
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(s, data, gen)
        torch.cuda.synchronize()
        times[kind].append(1e3 * (time.perf_counter() - t0))
    fused_ms, plain_ms = (float(np.median(times[k])) for k in ("fused", "plain"))
    log(f"sweep ms, median of 3: fused {fused_ms:.1f} {times['fused']}, "
        f"plain {plain_ms:.1f} {times['plain']}")

    # each kernel against its plain version, on this sweep's own inputs
    mu, binv, base, _ = blocked.fused_assign_inputs(s, data, gen)
    seed = _seed(7, dev)
    exact = assign_exact_check(ga.fused_gaussian_assign(x, mu, binv, base, seed),
                               x, mu, binv, base, seed)
    require_exact(exact, f"assign on the main path's inputs ({N}x{D}, K={K_MAX}), draw for draw")
    zi = torch.where(mask > 0, s.assignments, K_MAX)
    k1 = cuda_ms(lambda: ga.fused_gaussian_assign(x, mu, binv, base, seed), 3)
    p1 = cuda_ms(lambda: ga.gaussian_assign_plain(x, mu, binv, base, gen), 2)
    k2 = cuda_ms(lambda: ss.fused_scatter_stats(x, zi, K_MAX), 3)
    p2 = cuda_ms(lambda: ss.scatter_stats_plain(x, zi, K_MAX), 2)
    err2 = (ss.fused_scatter_stats(x, zi, K_MAX) - ss.scatter_stats_plain(x, zi, K_MAX)).abs().max().item()
    log(f"gaussian_assign {N}x{D} K={K_MAX}: kernel {k1:.2f} ms, plain {p1:.2f} ms")
    log(f"scatter_stats {N}x{D} K={K_MAX} (main-path z): kernel {k2:.2f} ms, plain {p2:.2f} ms, "
        f"max abs err {err2:.3e}")
    profile_sweep(run, gen)
    return {
        "kernels": [
            {"name": "gaussian_assign", "route": "cuda",
             "source": "common_tpu_torch/csrc/gaussian_assign.cu",
             "replaces": "common_tpu/ops/gaussian_assign.py:101",
             "launches": launches["gaussian_assign"],
             "max_abs_err": exact["shortfall"],
             "mismatch": exact["mismatch"], "tie_rows": exact["ties"],
             "agree": kernel_checks["assign_agree"],
             "ms": k1, "plain_ms": p1},
            {"name": "scatter_stats", "route": "cuda",
             "source": "common_tpu_torch/csrc/suffstat.cu",
             "replaces": "common_tpu/ops/suffstat.py:75",
             "launches": launches["suffstat"],
             "max_abs_err": err2, "ms": k2, "plain_ms": p2},
        ],
        "sweeps_per_s": N_SWEEPS / run_s,
        "fused_sweep_ms": fused_ms, "plain_sweep_ms": plain_ms,
        "heldout_logp_per_dim": lp_dim,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one", file=sys.stderr)
        return 1
    try:
        env = phase_environment()
        checks = phase_kernels()
        result = phase_main_path(checks)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": result["kernels"]}))
    log(json.dumps({"main_path": {k: v for k, v in result.items() if k != "kernels"},
                    "card": env["card"]}))
    log(env["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
