"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, and the collapsed sweep's card-only properties (no host wait, bit-exact resume).

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from common_tpu_torch.ops import gaussian_assign as ga
from common_tpu_torch.ops import linear_assign as la
from common_tpu_torch.ops import suffstat as ss

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _assign_problem(n, d, k, sep, seed, device):
    """Rows around k centers `sep` apart, a dense triangular B_k per cluster.

    With sep small the clusters differ mostly in B_k, so every row's draw
    hangs on all of B_k."""
    r = np.random.default_rng(seed)
    mu = r.normal(scale=sep, size=(k, d))
    X = mu[r.integers(0, k, n)] + r.normal(size=(n, d))
    binv = np.tril(r.normal(scale=d ** -0.5, size=(k, d, d)), -1) + np.eye(d) * r.uniform(0.5, 1.5, (k, 1, d))
    base = r.normal(size=k)
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in (X, mu, binv, base)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,sep", [(5000, 64, 16, 8.0), (777, 20, 3, 8.0),
                                       (3001, 256, 64, 0.3), (130, 40, 5, 0.3)])
def test_cuda_assign_kernel_matches_plain(cuda_device, n, d, k, sep):
    """z equals the argmax of the plain scores plus the kernel's own Philox
    noise on every row outside the fp32 tie band."""
    t = _assign_problem(n, d, k, sep, 5, cuda_device)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda_device)
    z = ga.fused_gaussian_assign(*t, seed).long()
    _assert_exact(z, ga.philox_scores(*t, seed))


def _assert_exact(z, v):
    """z is the argmax of v on every row outside the fp32 tie band."""
    top2, arg = v.topk(2, dim=-1)
    tie = (top2[:, 0] - top2[:, 1]) <= 3e-5 * top2[:, 0].abs() + 1e-3
    assert int(tie.sum()) <= 0.01 * len(z)
    assert torch.equal(z.long()[~tie], arg[~tie, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,c", [(3001, 20, 7, 3), (4097, 64, 16, 1), (1537, 256, 9, 3),
                                     (130, 256, 64, 3)])
def test_cuda_chains_kernel_matches_plain(cuda_device, n, d, k, c):
    """Each chain's z is the argmax of its slots' plain scores plus the
    kernel's Philox noise with the chain word, on dense (not triangular)
    B_k; chain 0 is exactly the single-chain kernel on its slots."""
    r = np.random.default_rng(n + c)
    X, _, _, _ = _assign_problem(n, d, 1, 0.3, n, cuda_device)
    mu = torch.tensor(r.normal(scale=0.3, size=(c * k, d)), dtype=torch.float32, device=cuda_device)
    binv = torch.tensor(r.normal(scale=d ** -0.5, size=(c * k, d, d)) + np.eye(d),
                        dtype=torch.float32, device=cuda_device)
    base = torch.tensor(r.normal(size=c * k), dtype=torch.float32, device=cuda_device)
    seed = torch.tensor([11], dtype=torch.int32, device=cuda_device)
    before = ga.fused_gaussian_assign_chains.launches
    z = ga.fused_gaussian_assign_chains(X, mu, binv, base, seed, c)
    assert ga.fused_gaussian_assign_chains.launches == before + 1
    assert z.shape == (c, n) and z.dtype == torch.int32
    for ch in range(c):
        sl = slice(ch * k, (ch + 1) * k)
        _assert_exact(z[ch], ga.philox_scores(X, mu[sl], binv[sl], base[sl], seed, chain=ch))
    z1 = ga.fused_gaussian_assign(X, mu[:k].contiguous(), binv[:k].contiguous(),
                                  base[:k].contiguous(), seed)
    assert torch.equal(z[0], z1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(100_003, 64, 32), (3001, 20, 7), (777, 256, 40), (999, 300, 33),
                                   (100, 61, 70), (4099, 64, 1)])
def test_cuda_linear_kernel_matches_plain(cuda_device, n, d, k):
    """z is the argmax of X @ W^T + base plus the kernel's Philox noise on
    every row outside the fp32 tie band (binary rows, bbv's W and base):
    one panel and chunk, several of either, a D of 4-byte copies, a group of
    four clusters cut short, and a single cluster."""
    r = np.random.default_rng(n)
    p = r.uniform(0.05, 0.95, size=(k, d))
    X = torch.tensor(r.random((n, d)) < p[r.integers(0, k, n)], dtype=torch.float32,
                     device=cuda_device)
    W = torch.tensor(np.log(p) - np.log1p(-p), dtype=torch.float32, device=cuda_device)
    base = torch.tensor(np.log1p(-p).sum(-1) + np.log(r.dirichlet(np.ones(k))),
                        dtype=torch.float32, device=cuda_device)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    before = la.fused_linear_assign.launches
    z = la.fused_linear_assign(X, W, base, seed)
    assert la.fused_linear_assign.launches == before + 1
    if k == 1:
        assert torch.equal(z, torch.zeros_like(z))
    else:
        _assert_exact(z, la.linear_philox_scores(X, W, base, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [1537, 2048])
def test_cuda_assign_kernel_row_shards_equal_one_launch(cuda_device, cut):
    """Kernel 1 over rows [0, cut) and [cut, N) with row_offset 0 and cut
    equals one launch over all N rows, row for row outside the fp32 tie
    band (the shard moves a row within its 128-row tile when cut is not a
    multiple of 128); each shard is its plain scores plus the noise of its
    global rows."""
    t = _assign_problem(4099, 256, 64, 0.3, 17, cuda_device)
    X, rest = t[0], t[1:]
    seed = torch.tensor([11], dtype=torch.int32, device=cuda_device)
    before = ga.fused_gaussian_assign.wgmma
    whole = ga.fused_gaussian_assign(X, *rest, seed)
    parts = torch.cat([ga.fused_gaussian_assign(X[:cut].contiguous(), *rest, seed, row_offset=0),
                       ga.fused_gaussian_assign(X[cut:].contiguous(), *rest, seed, row_offset=cut)])
    assert ga.fused_gaussian_assign.wgmma == before + 3  # D = 256: the warpgroup route
    v = ga.philox_scores(X, *rest, seed)
    top2 = v.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= 3e-5 * top2[:, 0].abs() + 1e-3
    assert torch.equal(parts[~tie], whole[~tie])
    _assert_exact(parts[cut:], ga.philox_scores(X[cut:], *rest, seed, row0=cut))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 16, 64, 203, 256, 384])
@pytest.mark.parametrize("k", [1, 5, 64])
def test_cuda_assign_kernel_at_every_tiling(cuda_device, d, k):
    """Draw for draw at a ragged N over the kernel's routes and tilings:
    the warpgroup route at D = 4, 16 and 64 (one 64-wide product) and 256,
    `mma.sync` at D = 203 (no 16-byte row; no panel filled) and 384 (64 x 32
    warp tiles and 16-input panels); for one slot, a few and the main
    path's 64."""
    t = _assign_problem(1000 + 37, d, k, 0.3, 100 * d + k, cuda_device)
    seed = torch.tensor([d + k], dtype=torch.int32, device=cuda_device)
    before = ga.fused_gaussian_assign.wgmma
    z = ga.fused_gaussian_assign(*t, seed)
    assert ga.fused_gaussian_assign.wgmma == before + (d not in (203, 384))
    if k == 1:
        assert torch.equal(z, torch.zeros_like(z))
    else:
        _assert_exact(z, ga.philox_scores(*t, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 4])
def test_cuda_chains_kernel_at_the_main_path_width(cuda_device, c):
    """The chain form at D = 256, K = 64 on dense B_k: each chain draw for
    draw, and chain 0 equal to the single-chain kernel bit for bit."""
    n, d, k = 2048 + 5, 256, 64
    r = np.random.default_rng(c)
    X, _, _, _ = _assign_problem(n, d, 1, 0.3, c, cuda_device)
    mu = torch.tensor(r.normal(scale=0.3, size=(c * k, d)), dtype=torch.float32, device=cuda_device)
    binv = torch.tensor(r.normal(scale=d ** -0.5, size=(c * k, d, d)) + np.eye(d),
                        dtype=torch.float32, device=cuda_device)
    base = torch.tensor(r.normal(size=c * k), dtype=torch.float32, device=cuda_device)
    seed = torch.tensor([17], dtype=torch.int32, device=cuda_device)
    before = ga.fused_gaussian_assign_chains.wgmma
    z = ga.fused_gaussian_assign_chains(X, mu, binv, base, seed, c)
    assert ga.fused_gaussian_assign_chains.wgmma == before + 1
    for ch in range(c):
        sl = slice(ch * k, (ch + 1) * k)
        _assert_exact(z[ch], ga.philox_scores(X, mu[sl], binv[sl], base[sl], seed, chain=ch))
    assert torch.equal(z[0], ga.fused_gaussian_assign(X, mu[:k], binv[:k], base[:k], seed))


def _card_problem(n, d, k, seed, device):
    """`_assign_problem`'s rows and dense triangular B_k, drawn on the card
    (the main path's 1M x 256 rows in well under a second)."""
    g = torch.Generator(device=device).manual_seed(seed)
    mu = 0.3 * torch.randn((k, d), generator=g, device=device)
    X = mu[torch.randint(0, k, (n,), generator=g, device=device)] + torch.randn((n, d), generator=g, device=device)
    scale = 0.5 + torch.rand((k, 1, d), generator=g, device=device)
    binv = torch.tril(torch.randn((k, d, d), generator=g, device=device) * d ** -0.5, -1)
    binv = binv + torch.eye(d, device=device) * scale
    return X, mu, binv.contiguous(), torch.randn(k, generator=g, device=device)


@pytest.mark.cuda
def test_cuda_wgmma_route_matches_plain_at_the_main_path_size(cuda_device):
    """The warpgroup route at the main path's 1M x 256, K = 64: every row
    is the argmax of its plain scores plus the kernel's Philox noise outside
    the fp32 tie band, and the launch counts once in `launches` and once in
    `wgmma`."""
    n, d, k = 1 << 20, 256, 64
    X, mu, binv, base = _card_problem(n, d, k, n + d, cuda_device)
    seed = torch.tensor([2**31 - 7], dtype=torch.int32, device=cuda_device)
    before = (ga.fused_gaussian_assign.launches, ga.fused_gaussian_assign.wgmma)
    z = ga.fused_gaussian_assign(X, mu, binv, base, seed)
    assert (ga.fused_gaussian_assign.launches, ga.fused_gaussian_assign.wgmma) == (before[0] + 1, before[1] + 1)
    for a in range(0, n, 1 << 17):
        b = min(n, a + (1 << 17))
        _assert_exact(z[a:b], ga.philox_scores(X[a:b], mu, binv, base, seed, row0=a))


@pytest.mark.cuda
@pytest.mark.parametrize("d,offset,route", [(256, 0, "wgmma"), (16, 0, "wgmma"), (203, 0, "mma"),
                                            (384, 0, "mma"), (256, 1, "mma")])
def test_cuda_assign_route_follows_width_and_alignment(cuda_device, d, offset, route):
    """D and X's alignment alone choose the route: D = 203 (rows of no
    whole 16-byte pieces), D = 384 (past the warpgroup route's 256) and an X
    4 bytes off a 16-byte boundary take `mma.sync`, and draw as the plain
    version does; the wrapper's `wgmma` counts only the warpgroup route."""
    n, k = 1000 + 37, 9
    X, mu, binv, base = _card_problem(n, d, k, d + offset, cuda_device)
    if offset:
        X = torch.cat([torch.zeros(offset, device=cuda_device), X.reshape(-1)])[offset:].view(n, d)
    assert (X.data_ptr() % 16 == 0) == (offset == 0) and X.is_contiguous()
    seed = torch.tensor([d], dtype=torch.int32, device=cuda_device)
    before = ga.fused_gaussian_assign.wgmma
    z = ga.fused_gaussian_assign(X, mu, binv, base, seed)
    assert ga.fused_gaussian_assign.wgmma - before == (route == "wgmma")
    _assert_exact(z, ga.philox_scores(X, mu, binv, base, seed))


@pytest.mark.cuda
def test_cuda_wgmma_counter_equals_launches_in_a_fused_sweep(cuda_device):
    """In the program's record of fused sweeps at D = 256, the counter
    `assign.wgmma` equals kernel 1's launches, one a sweep."""
    from common_tpu_torch import models, rng, state as st
    from common_tpu_torch.kernels import blocked
    from common_tpu_torch.utils import profiling

    n, d = 4096, 256
    X, _, _, _ = _card_problem(n, d, 4, 3, cuda_device)
    data = ((X, torch.ones(n, device=cuda_device)),)
    defn = st.model_definition(n, [models.niw(d)], k_max=8)
    s = st.initialize(defn, data, rng(0, cuda_device).generator, cluster_hp={"alpha": 1.0})
    gen = rng(1, cuda_device).generator
    before = ga.fused_gaussian_assign.launches
    with profiling.recording() as rec:
        for _ in range(3):
            s = blocked.sweep_fused(s, data, gen)
    assert ga.fused_gaussian_assign.launches - before == 3
    assert rec.counters.get("assign.wgmma") == 3


@pytest.mark.cuda
def test_cuda_scatter_kernel_on_a_large_cluster_against_float64(cuda_device):
    """One cluster of 332k rows at D = 256 (the main path's largest holds
    about a third of 1M rows) within 1e-5 of float64, a small one too, an
    empty one exactly 0, and every sum_xxT equal to its transpose."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    n, d = 333_333, 256
    centers = 4.0 * torch.randn(8, d, generator=g, device=cuda_device)
    X = centers[torch.randint(0, 8, (n,), generator=g, device=cuda_device)]
    X += torch.randn(n, d, generator=g, device=cuda_device)
    z = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    z[:1000] = 2
    got = ss.fused_scatter_stats(X, z, 3)
    for c in (0, 2):
        rows = X[z == c].double()
        want = rows.T @ rows
        assert ((got[c].double() - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.cuda
def test_cuda_scatter_kernel_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    X = torch.randn(20011, 72, generator=g, device=cuda_device)
    z = torch.randint(-1, 10, (20011,), generator=g, device=cuda_device, dtype=torch.int32)
    got = ss.fused_scatter_stats(X, z, 9)
    want = ss.scatter_stats_plain(X, z, 9)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _collapsed_problem(n, device):
    """Rows around three planted 2-D centers, the NIW DPMM of BASELINE config 1."""
    from common_tpu_torch import models, rng, state as st

    r = np.random.default_rng(0)
    centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    X = (centers[r.integers(0, 3, n)] + r.normal(scale=0.6, size=(n, 2))).astype(np.float32)
    data = ((torch.from_numpy(X).to(device), torch.ones(n, device=device)),)
    defn = st.model_definition(n, [models.niw(2)], k_max=16)
    return defn, data, st.initialize(defn, data, rng(0, device).generator, cluster_hp={"alpha": 1.0})


@pytest.mark.cuda
def test_cuda_collapsed_sweep_never_waits_and_resumes_bit_exactly(cuda_device):
    """One collapsed sweep runs under set_sync_debug_mode("error"); a run
    checkpointed after one sweep, with its generator, and resumed equals
    the uninterrupted run bit for bit."""
    from common_tpu_torch import io, rng, scalar_functions as sf
    from common_tpu_torch.kernels import gibbs
    from common_tpu_torch.runner import run_chain

    defn, data, s0 = _collapsed_problem(200, cuda_device)
    g = rng(1, cuda_device).generator
    gibbs.assign(s0, data, g)  # first use: library set-up outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gibbs.assign_resample(s0, data, g, m=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out.counts.sum()) == 200

    config = [("assign", {}), ("grid_cluster_hp", {"prior": sf.log_exponential(1.0),
                                                   "grid": np.geomspace(0.1, 10, 30)})]
    straight, trace = run_chain(s0, data, rng(5, cuda_device).generator, 3, config)
    g = rng(5, cuda_device).generator
    half, t1 = run_chain(s0, data, g, 1, config)
    restored, extra = io.deserialize(io.serialize(half, extra={"gen": g}), device=cuda_device)
    resumed, t2 = run_chain(restored, data, extra["gen"], 2, config)
    assert torch.equal(trace["assignments"], torch.cat([t1["assignments"], t2["assignments"]]))
    assert torch.equal(trace["score"], torch.cat([t1["score"], t2["score"]]))
    assert torch.equal(straight.stats[0]["sum_xxT"], resumed.stats[0]["sum_xxT"])


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
def test_cuda_block_stats_match_stats_from_assignments(cuda_device, stacked):
    """`blocked.block_stats` on the card (one launch of the scatter kernel for
    all P assignments) against niw's plain `stats_from_assignments`, with
    masked rows, rows outside the window (valid False) and ids outside
    [0, K); P = 4 assignments of 3000 rows at D = 40, K = 7, or one."""
    from common_tpu_torch import models, rng, state as st
    from common_tpu_torch.kernels import blocked
    from common_tpu_torch.parallel import stack_states

    r = np.random.default_rng(4)
    n, d, k, p = 3000, 40, 7, 4
    X = torch.tensor(r.normal(scale=2.0, size=(n, d)), dtype=torch.float32, device=cuda_device)
    mask = torch.tensor(r.random(n) > 0.1, dtype=torch.float32, device=cuda_device)
    valid = torch.arange(n, device=cuda_device) < n - 123
    z = torch.tensor(r.integers(-1, k + 1, (p, n)), dtype=torch.int32, device=cuda_device)
    defn = st.model_definition(n, [models.niw(d)], k_max=k)
    one = st.initialize(defn, ((X, mask),), rng(0, cuda_device).generator)
    state = stack_states([one] * p) if stacked else one
    zz = z if stacked else z[0]
    before = ss.fused_scatter_stats.launches
    got = blocked.block_stats(state, ((X, mask),), zz, valid)[0]
    assert ss.fused_scatter_stats.launches == before + 1
    lik = one.likelihoods()[0]
    for i in range(p if stacked else 1):
        want = lik.stats_from_assignments(one.hypers[0], X, mask * valid, z[i], k)
        for leaf, v in want.items():
            g = got[leaf][i] if stacked else got[leaf]
            assert (g - v).abs().max().item() <= 1e-5 * v.abs().max().item(), leaf


def _config3_state(device, n=4000, d=16, k=32, dtype=torch.float32):
    """A niw(d) + gp + bb state of config 3's shape at n rows, on `device`."""
    from common_tpu_torch import models, rng, state as st

    r = np.random.default_rng(9)
    z = r.integers(0, 8, n)
    cols = [4.0 * r.normal(size=(8, d))[z] + r.normal(size=(n, d)),
            r.poisson(np.exp(r.normal(size=8))[z]), r.random(n) < r.beta(0.5, 0.5, 8)[z]]
    data = tuple((torch.tensor(c, dtype=dtype, device=device), torch.ones(n, dtype=dtype, device=device))
                 for c in cols)
    defn = st.model_definition(n, [models.niw(d), models.gp, models.bb], k_max=k)
    hps = [{"mu0": np.zeros(d), "kappa": 1.0, "psi": np.eye(d), "nu": d + 2.0},
           {"alpha": 1.3, "inv_beta": 0.7}, {"alpha": 0.8, "beta": 1.2}]
    s = st.initialize(defn, data, rng(3, device).generator, cluster_hp={"alpha": 1.0}, feature_hps=hps,
                      assignment=r.integers(0, k - 4, n).astype(np.int32))
    return defn, data, hps, s


def _priors():
    from common_tpu_torch import scalar_functions as sf

    exp1 = sf.log_exponential(1.0)
    return {1: lambda h: exp1(h["alpha"]) + exp1(h["inv_beta"]),
            2: lambda h: exp1(h["alpha"]) + exp1(h["beta"])}


@pytest.mark.cuda
def test_cuda_nuts_hp_target_gradient_matches_float64(cuda_device):
    """nuts_hp's target (gp and bb hypers of a config-3-shaped state, 4000
    rows, K = 32): value and gradient in fp32 on the card against float64
    on the CPU, to 1e-5 of the largest gradient entry (value: 1e-6)."""
    from common_tpu_torch.kernels import hmc

    _, _, _, gpu = _config3_state(cuda_device)
    _, _, _, cpu = _config3_state("cpu", dtype=torch.float64)
    f32, q32, _, _ = hmc.hyper_logprob(gpu, _priors())
    f64, q64, _, _ = hmc.hyper_logprob(cpu, _priors())
    v32, g32 = hmc.value_and_grad(f32)(q32)
    v64, g64 = hmc.value_and_grad(f64)(q64)
    assert g32.device.type == "cuda" and g32.dtype == torch.float32
    assert abs(v32.item() - v64.item()) <= 1e-6 * abs(v64.item())
    assert (g32.double().cpu() - g64).abs().max().item() <= 1e-5 * g64.abs().max().item()


@pytest.mark.cuda
def test_cuda_niw_expfam_matches_float64(cuda_device):
    """NIW's `stats_from_weights` and `expected_loglik_table` at D = 16,
    K = 32 on the card against float64 on the CPU: the stats to 1e-5 of
    each leaf's largest entry, the table to 1e-5 of its largest entry."""
    from common_tpu_torch import likelihoods as tlik
    from common_tpu_torch.likelihoods import expfam

    _, data, _, gpu = _config3_state(cuda_device)
    _, data64, _, cpu = _config3_state("cpu", dtype=torch.float64)
    lik = tlik.get("niw")
    r = torch.softmax(torch.tensor(np.random.default_rng(2).normal(size=(4000, 32))), -1)
    (x, m), (x64, m64) = data[0], data64[0]
    got = lik.stats_from_weights(gpu.hypers[0], x, m, r.float().to(cuda_device))
    want = lik.stats_from_weights(cpu.hypers[0], x64, m64, r)
    for leaf, v in want.items():
        assert (got[leaf].double().cpu() - v).abs().max().item() <= 1e-5 * v.abs().max().item(), leaf
    t32 = expfam.expected_loglik_table(lik, gpu.hypers[0], lik.posterior_hyper(gpu.hypers[0], got), x, m)
    t64 = expfam.expected_loglik_table(lik, cpu.hypers[0], lik.posterior_hyper(cpu.hypers[0], want), x64, m64)
    assert t32.shape == (4000, 32) and t32.device.type == "cuda"
    assert (t32.double().cpu() - t64).abs().max().item() <= 1e-5 * t64.abs().max().item()


@pytest.mark.cuda
def test_cuda_cavi_step_matches_the_cpu(cuda_device):
    """One CAVI step on the card from a posterior carried to the CPU in
    float64: vstats to rtol 1e-3 with an atol of 1e-4 of each leaf's largest
    entry, the ELBO to 1e-6."""
    from common_tpu_torch import convert
    from common_tpu_torch.kernels import svi

    defn, data, hps, _ = _config3_state(cuda_device)
    post = svi.init(defn, data, torch.Generator(cuda_device).manual_seed(5), cluster_hp={"alpha": 1.0},
                    feature_hps=hps)

    def f64(tree):
        if isinstance(tree, dict):
            return {k: f64(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(f64(v) for v in tree)
        return tree.astype(np.float64) if isinstance(tree, np.ndarray) and tree.dtype.kind == "f" else tree

    post64 = convert.svi_from_numpy(f64(convert.svi_to_numpy(post)), device="cpu")
    data64 = tuple((x.double().cpu(), m.double().cpu()) for x, m in data)
    got, e32 = svi.fit_cavi(post, data, 1)
    want, e64 = svi.fit_cavi(post64, data64, 1)
    assert abs(e32.item() - e64.item()) <= 1e-6 * abs(e64.item())
    for a_f, b_f in zip(got.vstats, want.vstats):
        for leaf, b in b_f.items():
            a = a_f[leaf].double().cpu()
            assert ((a - b).abs() <= 1e-3 * b.abs() + 1e-4 * b.abs().max()).all(), leaf


@pytest.mark.cuda
@pytest.mark.parametrize("rows,event,n", [(1 << 20, (32,), 4097), (1 << 22, (), 1024), (100_003, (3, 2), 7)])
def test_cuda_segment_sum_replays_and_never_waits(cuda_device, rows, event, n):
    """`utils.segment.segment_sum` on the card, at an IRM table chunk's shape
    (1M x 32 into 4096 entities and a dropped bin), a restat's (4M scalars
    into 1024 blocks) and a ragged one: two calls equal bit for bit, no
    host wait under set_sync_debug_mode("error"), the CPU's float32 sum of
    the same rows equal bit for bit (one order on both), and float64's
    within float32's rounding."""
    from common_tpu_torch.utils import segment

    r = np.random.default_rng(0)
    ids = torch.from_numpy(np.sort(r.integers(0, n + 1, rows)))  # long runs, and dropped rows
    values = torch.from_numpy(r.normal(size=(rows, *event)).astype(np.float32))
    ids_d, values_d = ids.to(cuda_device), values.to(cuda_device)
    segment.segment_sum(values_d, ids_d, n)  # first use: library set-up outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = segment.segment_sum(values_d, ids_d, n)
        b = segment.segment_sum(values_d, ids_d, n)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), segment.segment_sum(values, ids, n))
    kept, x = ids[ids < n], values[ids < n].double()
    want = torch.zeros((n, *event), dtype=torch.float64).index_add_(0, kept, x)
    size = torch.zeros((n, *event), dtype=torch.float64).index_add_(0, kept, x.abs())
    # two levels of at most 64 and rows / 64 + 1 adds: (64 + 4097) float32 roundings of sum |x| at worst
    assert ((a.cpu().double() - want).abs() <= 4161 * 2.0 ** -24 * size).all()


@pytest.mark.cuda
def test_cuda_tree_segment_sum_replays_and_never_waits(cuda_device):
    """The tree layout (`segments(..., tree=True)`, the IRM restat's) at a
    restat chunk's shape, 4M scalars into 1024 blocks with two blocks
    holding most rows: two calls equal bit for bit, no host wait, the CPU's
    sum equal bit for bit, and no level's thread sums more than PIECE."""
    from common_tpu_torch.utils import segment

    r = np.random.default_rng(1)
    rows, n = 1 << 22, 1024
    ids = torch.from_numpy(np.where(r.random(rows) < 0.9, r.integers(0, 2, rows), r.integers(0, n + 1, rows)))
    values = torch.from_numpy(r.normal(size=rows).astype(np.float32))
    ids_d, values_d = ids.to(cuda_device), values.to(cuda_device)
    segment.segments(ids_d, n, tree=True).sum(values_d)  # first use: library set-up outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        layout = segment.segments(ids_d, n, tree=True)
        a, b = layout.sum(values_d), layout.sum(values_d)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), segment.segments(ids, n, tree=True).sum(values))
    assert len(layout.inner) == 2
    for offsets in (layout.pieces, *layout.inner, layout.first):
        assert int(torch.diff(offsets).max()) <= segment.PIECE


# each bench tier at a small shape on the card, and the kernels its path launches
BENCH_TIERS = {
    "run_tier(fused)": (lambda b, dev: b.run_tier(4096, 32, 16, 3, 0, kernel="fused", heldout=64, device=dev),
                        {"gaussian_assign": 6, "scatter_stats": 6}),
    "run_ess_tier": (lambda b, dev: b.run_ess_tier(2048, 16, 8, 0, sweeps=25, n_seeds=2, heldout=64, device=dev),
                     {"gaussian_assign": 50, "scatter_stats": 50}),
    "run_chains_headline_tier": (lambda b, dev: b.run_chains_headline_tier(0, 2048, 16, 8, sweeps=2, repeats=1,
                                                                           device=dev),
                                 {"gaussian_assign_chains": 4}),
    "run_chain_scaling_tier": (lambda b, dev: b.run_chain_scaling_tier(0, n=2048, d=8, k_max=8, sweeps=2,
                                                                       chain_counts=(1, 2), repeats=1, device=dev),
                               {"gaussian_assign_chains": 8}),
    "run_config2_tier": (lambda b, dev: b.run_config2_tier(0, n=2048, d=16, k_max=8, sweeps=2, heldout=64,
                                                           device=dev),
                         {"linear_assign": 4}),
    "run_smc_tier": (lambda b, dev: b.run_smc_tier(2048, 8, 8, 4, 0, block=512, warmup=64, heldout=64,
                                                   device=dev),
                     {"scatter_stats": 2 * 4 * 3}),
    "run_config3_tier": (lambda b, dev: b.run_config3_tier(0, n=512, k_max=8, sweeps=1, heldout=32, device=dev), {}),
    # 4 chunks a sweep, 2 sweeps a run: the warm-up, the timed run and HDP_MORE (5) more
    "run_hdp_tier": (lambda b, dev: b.run_hdp_tier(256, 10, 6, 40, 2, 0, doc_chunk=64, heldout_frac=0.1,
                                                   device=dev), {"hdp_assign": 4 * 2 * 7}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(BENCH_TIERS))
def test_cuda_bench_tier_launches_its_kernels(cuda_device, tier):
    """A bench tier on the card launches exactly its path's kernels: the fused
    sweep kernels 1 and 2 a sweep (warm-up and timed run), path A kernel 4 a
    sweep (at these widths its restat is the wide product, not kernel 2),
    config 2 kernel 3 an iteration of its fused variant, config 5 kernel 2
    three times a block, config 4 the HDP kernel a chunk of docs, config 3
    none."""
    from common_tpu_torch import bench

    run, want = BENCH_TIERS[tier]
    out = run(bench, cuda_device)
    names = ("gaussian_assign", "gaussian_assign_chains", "linear_assign", "scatter_stats", "hdp_assign")
    assert out["launches"] == {name: want.get(name, 0) for name in names}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["blocked", "fused"])
def test_cuda_bench_timed_run_never_waits(cuda_device, kernel):
    """A bench tier's timed run (sweeps with the score and k_active trace)
    makes every launch without a host wait, so the synchronize that ends
    its window is the run's only one."""
    from common_tpu_torch import bench

    setup, run = bench.build_tier_fn(4096, 32, 16, 3, kernel, multi_stat=True, device=cuda_device)
    data, _, s = setup(0, 17)
    run(data, s, bench._generator(cuda_device, 0, 17, 2))  # the warm-up: one-time set-up may wait
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, trace = run(data, s, bench._generator(cuda_device, 0, 17, 2))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert trace.shape == (3, 2) and bool(torch.isfinite(trace).all())
    assert int(out.counts.sum()) == 4096


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bb", "bnb", "bbv", "bbnc"])
def test_cuda_beta_draw_stays_inside_the_support(cuda_device, name):
    """On the card, `sample_params` at 10^6 heads (bnb: zero counts) and hyper
    beta 0.5: a plain `rng.beta` from the same generator state puts some
    draws at exactly 1.0, `sample_params` none at 0 or 1 (those at the
    largest float below 1), and its score table is finite."""
    from common_tpu_torch.rng import beta
    from torch_support_cases import extreme, scores

    lik, hyper, stats, X, (a, b) = extreme(name, cuda_device)
    theta = lik.sample_params(torch.Generator(device=cuda_device).manual_seed(0), hyper, stats)
    raw = beta(a, b, torch.Generator(device=cuda_device).manual_seed(0))
    p = theta["p"]
    assert int((raw == 1).sum()) > 0
    assert bool(((p > 0) & (p < 1)).all())
    assert torch.equal(p[raw == 1], torch.full_like(p[raw == 1], 1.0 - 2.0 ** -24))
    assert bool(torch.isfinite(scores(lik, theta, X)).all())


@pytest.mark.cuda
def test_cuda_gamma_draw_is_at_least_tiny(cuda_device):
    """torch's Gamma sampler on the card clamps its draw at finfo.tiny, as on the CPU."""
    from common_tpu_torch.rng import standard_gamma

    g = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        x = standard_gamma(torch.full((100_000,), 1e-3, dtype=dtype, device=cuda_device), g)
        assert float(x.min()) == torch.finfo(dtype).tiny


@pytest.mark.cuda
def test_cuda_every_sync_of_slice_hp_and_block_smc_is_a_counted_read(cuda_device):
    """One slice_hp iteration (config 2's shape) and a block-SMC pass of 128
    warm-up rows and 2 blocks (the smc cell's widths) under
    set_sync_debug_mode("warn") with the recorder on: every synchronisation
    the card reports is raised inside an open `read.<site>` span, so the
    recorder's read counts are all the host's waits on these paths."""
    import traceback
    import warnings

    from common_tpu_torch import models, rng, scalar_functions as sf, state as st
    from common_tpu_torch.kernels import smc
    from common_tpu_torch.runner import runner
    from common_tpu_torch.utils import profiling

    g = torch.Generator(device=cuda_device).manual_seed(3)
    n, d = 100_000, 64
    profiles = torch.rand((8, d), generator=g, device=cuda_device)
    rows = torch.randint(0, 8, (n,), generator=g, device=cuda_device)
    xb = (torch.rand((n, d), generator=g, device=cuda_device) < profiles[rows]).to(torch.float32)
    bdata = ((xb, torch.ones(n, device=cuda_device)),)
    defn = st.model_definition(n, [models.bbv(d)], k_max=32)
    s0 = st.initialize(defn, bdata, rng(0, cuda_device).generator, cluster_hp={"alpha": 1.0})
    spec = {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)}
    config = [("assign_blocked_fused", {}),
              ("slice_hp", {"specs": {0: {"alpha": spec, "beta": spec}},
                            "cluster": {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (1e-4, 1e4)}})]
    chain = runner(defn, bdata, s0, config)

    P, B, W, D = 16, 8192, 128, 256
    m = W + 2 * B
    xn = torch.randn((8, D), generator=g, device=cuda_device)[torch.randint(0, 8, (m,), generator=g,
                                                                             device=cuda_device)] * 4.0
    xn = xn + torch.randn((m, D), generator=g, device=cuda_device)
    ndata = ((xn, torch.ones(m, device=cuda_device)),)
    ndefn = st.model_definition(m, [models.niw(D)], k_max=64)
    hyper = {"mu0": np.zeros(D, np.float32), "kappa": 1.0, "psi": np.eye(D, dtype=np.float32), "nu": D + 2.0}

    def particles():
        return smc.init_particles(ndefn, ndata, rng(4, cuda_device).generator, P, cluster_hp={"alpha": 1.0},
                                  feature_hps=[hyper])

    gen = rng(1, cuda_device).generator
    chain.run(gen, 1)  # first use: library set-up and the kernels' build outside the check
    smc.run_blocked(particles(), ndata, gen, block=B, warmup=W)
    parts = particles()
    torch.cuda.synchronize()
    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):  # not the warning that turns the mode on
            rec = profiling._RECORD
            names = [rec.spans[i][0] for i in rec.open] if rec else []
            seen.append((names, "".join(traceback.format_stack(limit=8)[:-1])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.recording() as rec:
                chain.run(gen, 1)
                smc.run_blocked(parts, ndata, gen, block=B, warmup=W)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    outside = [stack for names, stack in seen if not any(name.startswith("read.") for name in names)]
    assert not outside, f"{len(outside)} of {len(seen)} syncs outside a read span; first:\n{outside[0]}"
    reads = rec.reads()
    assert reads["smc.ess"] == W + 2 and rec.reads(within="smc.block_step").get("smc.ess") == 2
    # the 129 hyper updates run whole on the card: no slice read inside slice_hp
    assert rec.counters["slice.fused_updates"] == 129
    assert rec.reads(within="runner.slice_hp") == {}
    # each read span saw at least its own synchronisation, and nothing else did
    assert len(seen) >= sum(reads.values())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 32, 70])
def test_cuda_slice_update_kernel_matches_plain_at_any_slot_count(cuda_device, k):
    """Random counts (a third of the slots empty) and heads, each kind of
    target, 20 updates of random coordinates with random levels and seeds
    and a bound on each side: the kernel equals the plain version bit for
    bit; K = 70 puts three slots on some lanes."""
    from common_tpu_torch.ops import slice_update as su

    g = torch.Generator(device=cuda_device).manual_seed(k)
    d = 7
    counts = torch.randint(1, 5000, (k,), generator=g, device=cuda_device, dtype=torch.int32)
    counts[torch.rand(k, generator=g, device=cuda_device) < 1 / 3] = 0
    n = counts.to(torch.float32)
    heads = torch.floor(n[:, None] * torch.rand((k, d), generator=g, device=cuda_device))
    other = 0.5 + 5 * torch.rand(d, generator=g, device=cuda_device)
    before = su.slice_update.launches
    for i in range(20):
        kind = i % 3
        target = su.HyperTarget(kind, 1.0, counts, i % d, other, n, heads)
        x0 = 0.5 + 5 * torch.rand((), generator=g, device=cuda_device)
        level = torch.rand((), generator=g, device=cuda_device).clamp_(1e-7, 1 - 2 ** -24)
        seed = torch.randint(0, 2**31 - 1, (1,), generator=g, device=cuda_device, dtype=torch.int32)
        args = (x0, level, seed, target, 0.5, 0.5, 50.0, 16, 64)
        assert torch.equal(su.slice_update(*args), su.slice_update_plain(*args)), (k, i)
    assert su.slice_update.launches == before + 20


@pytest.mark.cuda
def test_cuda_slice_update_kernel_matches_plain_over_an_iteration(cuda_device):
    """Config 2's shape (100k x 64 binary rows, K 32), a fused sweep, then
    `slice_.hp` on the Beta hypers and the concentration: each of the 129
    updates the kernel made equals the plain version's (`slice_update_plain`,
    host tests) run on the card from the same x0, level, seed and state, bit
    for bit, and lies on its slice."""
    from common_tpu_torch import models, rng, state as st
    from common_tpu_torch.bench import config2_hp_specs
    from common_tpu_torch.kernels import blocked, slice_
    from common_tpu_torch.ops import slice_update as su

    g = torch.Generator(device=cuda_device).manual_seed(5)
    n, d = 100_000, 64
    profiles = torch.rand((8, d), generator=g, device=cuda_device)
    rows = torch.randint(0, 8, (n,), generator=g, device=cuda_device)
    xb = (torch.rand((n, d), generator=g, device=cuda_device) < profiles[rows]).to(torch.float32)
    data = ((xb, torch.ones(n, device=cuda_device)),)
    defn = st.model_definition(n, [models.bbv(d)], k_max=32)
    s = st.initialize(defn, data, rng(0, cuda_device).generator, cluster_hp={"alpha": 1.0})
    gen = rng(1, cuda_device).generator
    for _ in range(3):
        s = blocked.sweep_fused(s, data, gen)
    calls = []
    real = slice_.slice_update

    def recording(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    launches = su.slice_update.launches
    slice_.slice_update = recording
    try:
        post = slice_.hp(s, data, gen, **config2_hp_specs())
    finally:
        slice_.slice_update = real
    assert len(calls) == 2 * d + 1 and su.slice_update.launches - launches == 2 * d + 1
    assert [c[0][3].kind for c in calls] == [su.KIND_ALPHA] * d + [su.KIND_BETA] * d + [su.KIND_CRP]
    for i, (args, out) in enumerate(calls):
        want = su.slice_update_plain(*args)
        assert torch.equal(out, want), (i, float(out), float(want))
        x0, level, target = args[0], args[1], args[3]
        assert float(target(out) - target(x0)) >= float(torch.log(level.double())) - 1e-9, i
    assert torch.equal(post.hypers[0]["alpha"], torch.stack([out for _, out in calls[:d]]))
    assert torch.equal(post.hypers[0]["beta"], torch.stack([out for _, out in calls[d:2 * d]]))
    assert torch.equal(post.cluster_hp["alpha"], calls[-1][1])
    moved = sum(int(out != args[0]) for args, out in calls)
    assert moved == len(calls)


@pytest.mark.cuda
def test_cuda_hdp_runner_trace_is_each_sweeps_z(cuda_device):
    """The HDP runner copies each chunk's z on a stream of its own, 4 bits a
    token (K = 12) into pinned memory: the trace read back after runs of 3
    and 2 sweeps is each sweep's z, as the same steps give it on the card."""
    from common_tpu_torch import rng, topic
    from common_tpu_torch.runner import HDP_FAMILY, make_step, runner

    g = torch.Generator(device=cuda_device).manual_seed(1)
    D, L, V, K = 3000, 40, 500, 12
    words = torch.randint(0, V, (D, L), generator=g, device=cuda_device)
    mask = (torch.rand((D, L), generator=g, device=cuda_device) > 0.05).float()
    data = topic.dense_token_data(words, mask)
    s = topic.initialize(data, K, V, rng(2, cuda_device).generator, n_docs=D)
    config = [("assign_blocked_dense", {"doc_chunk": 700}), ("beta", {})]
    step, gen, zs, x = make_step(config, data, HDP_FAMILY), rng(3, cuda_device).generator, [], s
    for _ in range(5):
        x = step(x, gen)
        zs.append(x.z.cpu().numpy())
    run = runner(None, data, s, config)
    gen = rng(3, cuda_device).generator
    run.run(gen, 3)
    run.run(gen, 2)
    assert [(p.data.dtype, p.data.shape, p.bits) for p in run._assignment_trace] == [
        (np.uint8, (3, D * L // 2), 4), (np.uint8, (2, D * L // 2), 4)]
    trace = run.assignment_trace
    assert trace.dtype == np.int32 and np.array_equal(trace, np.stack(zs))
    assert torch.equal(run.get_latent().z, x.z)
