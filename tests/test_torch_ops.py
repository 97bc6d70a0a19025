"""The port's kernel modules (`common_tpu_torch.ops`) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX functions they replace, the Pallas kernels run in interpret
mode as `tests/test_pallas.py` runs them. The kernels themselves are held
against these plain versions on the card in `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from common_tpu.likelihoods import niw as jniw
from common_tpu.ops.gaussian_assign import fused_gaussian_assign as j_assign
from common_tpu.ops.suffstat import fused_scatter_stats as j_scatter
from common_tpu_torch.ops import gaussian_assign as ga
from common_tpu_torch.ops import philox
from common_tpu_torch.ops import suffstat as ss

torch.set_num_threads(2)


def _gaussian_problem(n, d, k, seed):
    """A posterior-draw theta (mu, lower-triangular chol) with rows around it."""
    r = np.random.default_rng(seed)
    mu = r.normal(scale=2.0, size=(k, d)).astype(np.float32)
    a = r.normal(scale=0.3, size=(k, d, d))
    chol = np.tril(a, -1) + np.eye(d) * r.uniform(0.5, 1.5, size=(k, 1, d))
    X = (mu[r.integers(0, k, n)] + r.normal(size=(n, d))).astype(np.float32)
    logw = np.log(r.dirichlet(np.ones(k))).astype(np.float32)
    return X, mu, chol.astype(np.float32), logw


def _assign_inputs(mu, chol, logw):
    d = mu.shape[-1]
    binv = np.linalg.inv(chol.astype(np.float64)).astype(np.float32)
    logdet = 2.0 * np.log(np.diagonal(chol, axis1=-2, axis2=-1)).sum(-1)
    base = (logw - 0.5 * logdet - 0.5 * d * np.log(2 * np.pi)).astype(np.float32)
    return binv, base


def test_gaussian_scores_match_jax_logpdf_batch():
    X, mu, chol, logw = _gaussian_problem(400, 6, 5, 0)
    binv, base = _assign_inputs(mu, chol, logw)
    got = ga.gaussian_scores(*map(torch.from_numpy, (X, mu, binv, base))).numpy()
    want = np.asarray(jniw.logpdf_batch(
        {"mu": jnp.asarray(mu), "cov_chol": jnp.asarray(chol)},
        jnp.asarray(X), jnp.ones(400, jnp.float32),
    ))
    np.testing.assert_allclose(got - logw[None, :], want, rtol=1e-5, atol=1e-3)


def test_argmax_scores_match_pallas_interpret():
    """The interpreter's PRNG returns constant bits, so the Pallas kernel is a
    seed-independent argmax of base - 1/2 ||B(x - mu)||^2 there."""
    X, mu, chol, logw = _gaussian_problem(1500, 8, 6, 1)
    binv, base = _assign_inputs(mu, chol, logw)
    with pltpu.force_tpu_interpret_mode():
        zj = np.asarray(j_assign(*map(jnp.asarray, (X, mu, binv, base)), 7))
    s = ga.gaussian_scores(*map(torch.from_numpy, (X, mu, binv, base))).numpy()
    zt = s.argmax(-1)
    rows = np.arange(len(zt))
    diff = zj != zt
    assert diff.mean() <= 1e-3, diff.mean()
    gap = np.abs(s[rows, zj] - s[rows, zt])
    assert np.all(gap[diff] <= 1e-4 * np.abs(s[rows, zt][diff])), gap[diff]


def test_plain_assign_draws_follow_softmax():
    """gaussian_assign_plain samples the softmax of the score table."""
    X, mu, chol, logw = _gaussian_problem(3, 2, 4, 2)
    X = X * 0.2  # ambiguous rows
    binv, base = _assign_inputs(mu, chol, logw)
    t = [torch.from_numpy(a) for a in (X, mu, binv, base)]
    probs = torch.softmax(ga.gaussian_scores(*t).double(), -1).numpy()
    g = torch.Generator().manual_seed(0)
    reps = 4000
    z = torch.stack([ga.gaussian_assign_plain(*t, g) for _ in range(reps)]).numpy()
    for i in range(3):
        freq = np.bincount(z[:, i], minlength=4) / reps
        se = np.sqrt(probs[i] * (1 - probs[i]) / reps)
        assert np.all(np.abs(freq - probs[i]) < 5 * se + 1e-3), (freq, probs[i])


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_matches_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    def t(v):
        return torch.tensor([v], dtype=torch.int64)
    got = philox.philox4x32_10(tuple(map(t, ctr)), tuple(map(t, key)))
    assert tuple(int(w) for w in got) == want


def test_philox_gumbel_is_keyed_on_row_and_cluster():
    seed = torch.tensor([5], dtype=torch.int32)
    full = ga.philox_gumbel(seed, torch.arange(4000), 8)
    part = ga.philox_gumbel(seed, torch.arange(1000, 1100), 8)
    torch.testing.assert_close(part, full[1000:1100], rtol=0, atol=0)
    assert not torch.equal(full, ga.philox_gumbel(seed + 1, torch.arange(4000), 8))
    # standard Gumbel: mean = Euler's gamma, variance = pi^2 / 6; finite bounds
    se = np.sqrt(np.pi ** 2 / 6 / full.numel())
    assert abs(full.mean().item() - 0.5772157) < 5 * se
    assert abs(full.var().item() - np.pi ** 2 / 6) < 0.05
    assert -2.8 < full.min().item() and full.max().item() < 16.7


@pytest.mark.parametrize("n,tile", [(700, 128), (1000, 256)])
def test_scatter_plain_matches_pallas_interpret(n, tile):
    """Masked rows routed to K and a ragged N (not a tile multiple) included."""
    r = np.random.default_rng(3)
    d, K = 8, 6
    X = r.normal(size=(n, d)).astype(np.float32)
    z = r.integers(0, K + 1, n).astype(np.int32)  # K = masked: adds nothing
    want = np.asarray(j_scatter(jnp.asarray(X), jnp.asarray(z), K, tile_n=tile,
                                k_tile=4, interpret=True))
    got = ss.scatter_stats_plain(torch.from_numpy(X), torch.from_numpy(z), K).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # the wrapper takes the plain version for CPU tensors, without a launch
    before = ss.fused_scatter_stats.launches
    via = ss.fused_scatter_stats(torch.from_numpy(X), torch.from_numpy(z), K).numpy()
    np.testing.assert_array_equal(via, got)
    assert ss.fused_scatter_stats.launches == before


def test_cpu_assign_wrapper_is_the_plain_version_seeded():
    X, mu, chol, logw = _gaussian_problem(200, 4, 5, 4)
    binv, base = _assign_inputs(mu, chol, logw)
    t = [torch.from_numpy(a) for a in (X, mu, binv, base)]
    seed = torch.tensor([11], dtype=torch.int32)
    before = ga.fused_gaussian_assign.launches
    z = ga.fused_gaussian_assign(*t, seed)
    want = ga.gaussian_assign_plain(*t, torch.Generator().manual_seed(11))
    assert z.dtype == torch.int32 and torch.equal(z, want)
    assert ga.fused_gaussian_assign.launches == before


@pytest.mark.parametrize("d,offset,max_dim,want", [
    (256, 0, 256, True), (200, 0, 256, True), (16, 0, 256, True), (4, 0, 256, True),
    (203, 0, 256, False), (260, 0, 256, False), (384, 0, 384, False), (256, 1, 256, False),
    (256, 0, 0, False)])
def test_wgmma_route_follows_width_and_alignment(d, offset, max_dim, want):
    """The warpgroup route takes D a multiple of 4 up to its device's widest
    (and never past 256) with X on a 16-byte boundary; anything else goes to
    `mma.sync`. The rule reads nothing but D, X's address and the width."""
    buf = torch.zeros(3 * d + offset)
    X = buf[offset:].view(3, d)
    assert buf.data_ptr() % 16 == 0
    assert ga.wgmma_route(X, min(max_dim, 256)) is want


def test_wrappers_raise_on_devices_without_a_kernel_or_bad_shapes():
    X = torch.zeros(10, 3, device="meta")
    z = torch.zeros(10, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ss.fused_scatter_stats(X, z, 4)
    mu, binv, base = (torch.zeros(s, device="meta") for s in ((4, 3), (4, 3, 3), (4,)))
    seed = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ga.fused_gaussian_assign(X, mu, binv, base, seed)
    with pytest.raises(ValueError, match="shape"):
        ga.fused_gaussian_assign(torch.zeros(10, 3), torch.zeros(4, 2), torch.zeros(4, 3, 3),
                                 torch.zeros(4), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        ss.fused_scatter_stats(torch.zeros(10, 3), torch.zeros(9, dtype=torch.int32), 4)
