"""Why the assignment kernels use 3xTF32 split products, not TF32.

The CUDA kernels (`common_tpu_torch/csrc/gaussian_assign.cu`,
`linear_assign.cu`, `tf32x3.cuh`) compute each row's quadratic form
||B_k (x - mu_k)||^2, or its linear score x . w_k + base_k, on the tensor
cores, whose TF32 operands keep 10 of fp32's 23 mantissa bits. This file
emulates their arithmetic in numpy on main-path-like and config-2-like data
and holds the scores against float64, in the units of the tie band that the
card checks use (`chip_smoke.py` `exact_check`: 3e-5 * |top score| + 1e-3
nats): within it the kernels' draw may differ from the plain one, outside
it never.

- hi = x rounded to nearest at 10 mantissa bits (the kernels' bit trick),
  lo = x - hi exact in fp32, then truncated to TF32 as the tensor core
  reads it; a TF32 x TF32 product is exact in fp32 (11 x 11 significant
  bits), and the kernels accumulate in fp32, as the float32 products here.
- Three passes, lo_a hi_b + hi_a lo_b + hi_a hi_b, stay far inside the
  band; one pass, hi_a hi_b, misses by more than half the band on most
  rows.

The data: D = 256 rows from 8 planted centers at scale 4 plus unit noise
(the main path's), 16 clusters (the 8 centers and 8 near copies), B_k =
L_k^{-1} with L_k = chol(Sigma_k), Sigma_k = I + A A^T / (2D), as an NIW
posterior draw near the identity gives.
"""

import numpy as np
import pytest

D, K, N = 256, 16, 2000
RTOL, ATOL = 3e-5, 1e-3  # chip_smoke.py exact_check's tie band


def _tf32_round(a):
    """a rounded to nearest at TF32's 10 mantissa bits (ties away from 0)."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_truncate(a):
    """a as the tensor core reads an fp32 register: the low 13 bits dropped."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _products(a, b, passes):
    """a @ b.T as the kernels form it: fp32 sums of TF32 products."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    if passes == 1:
        return ah @ bh.T
    al, bl = _tf32_truncate(a - ah), _tf32_truncate(b - bh)
    return (al @ bh.T) + (ah @ bl.T) + (ah @ bh.T)


@pytest.fixture(scope="module")
def problem():
    r = np.random.default_rng(0)
    centers = 4.0 * r.standard_normal((8, D))
    X = (centers[r.integers(0, 8, N)] + r.standard_normal((N, D))).astype(np.float32)
    near = centers[r.integers(0, 8, K - 8)] + 0.3 * r.standard_normal((K - 8, D))
    mu = np.concatenate([centers, near]).astype(np.float32)
    A = r.standard_normal((K, D, D)) / np.sqrt(D)
    L = np.linalg.cholesky(np.eye(D) + 0.5 * A @ A.transpose(0, 2, 1))
    binv = np.linalg.inv(L).astype(np.float32)
    base = -np.log(np.diagonal(L, axis1=1, axis2=2)).sum(1) - 0.5 * D * np.log(2 * np.pi)
    return X, mu, binv, base.astype(np.float32)


def _scores(problem, passes):
    """[N, K] base_k - 1/2 ||B_k (x - mu_k)||^2: float64 (passes=0) or TF32 passes."""
    X, mu, binv, base = problem
    out = np.empty((N, K))
    for k in range(K):
        a = X - mu[k]  # centred in fp32 before the split, as the kernels do
        if passes == 0:
            y = a.astype(np.float64) @ binv[k].astype(np.float64).T
        else:
            y = _products(a, binv[k], passes).astype(np.float64)
        out[:, k] = base[k] - 0.5 * (y * y).sum(1)
    return out


@pytest.fixture(scope="module")
def reference(problem):
    """Float64 scores, each row's top two clusters and its tie band."""
    s64 = _scores(problem, 0)
    top2 = np.argsort(-s64, axis=1)[:, :2]
    band = RTOL * np.abs(np.take_along_axis(s64, top2[:, :1], 1)[:, 0]) + ATOL
    return s64, top2, band


def _error_in_bands(problem, reference, passes):
    """Per row: the largest score error of its top two clusters, in tie bands."""
    s64, top2, band = reference
    s = _scores(problem, passes)
    err = np.abs(np.take_along_axis(s, top2, 1) - np.take_along_axis(s64, top2, 1)).max(1)
    return err / band


def test_three_tf32_passes_stay_inside_the_tie_band(problem, reference):
    """3xTF32 split products: every row's top scores within 1/10 of its band
    of float64 (the emulation gives 0.014), so the draw matches the exact
    one outside the band."""
    ratio = _error_in_bands(problem, reference, passes=3)
    assert ratio.max() < 0.1, ratio.max()


def test_one_tf32_pass_leaves_the_tie_band(problem, reference):
    """A single TF32 pass misses float64 by more than half a band on most
    rows and by more than a whole band on a quarter of them (35 bands at
    worst in the emulation): it would change draws outside the band."""
    ratio = _error_in_bands(problem, reference, passes=1)
    assert (ratio > 0.5).mean() > 0.5, (ratio > 0.5).mean()
    assert (ratio > 1.0).mean() > 0.2, (ratio > 1.0).mean()
    assert ratio.max() > 10.0, ratio.max()


@pytest.mark.parametrize("passes", [1, 3])
def test_split_halves_are_tf32_and_sum_back(passes):
    """hi keeps 10 mantissa bits; hi + lo is x exactly; truncated lo is
    within 2^-10 |lo| of lo, so each 3-pass product is within 2^-21 of the
    exact one, near fp32's own rounding, and a 1-pass product within 2^-10."""
    r = np.random.default_rng(passes)
    x = (r.standard_normal(4096) * 10.0 ** r.uniform(-3, 3, 4096)).astype(np.float32)
    hi = _tf32_round(x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    lo = (x - hi).astype(np.float32)
    np.testing.assert_array_equal(hi.astype(np.float64) + lo.astype(np.float64), x.astype(np.float64))
    assert (np.abs(lo) <= np.abs(x) * 2.0 ** -11).all()
    lo_t = _tf32_truncate(lo)
    assert (np.abs(lo - lo_t) <= np.abs(lo) * 2.0 ** -10).all()
    prod = _products(x[:64, None], x[64:128, None], passes)
    exact = x[:64, None].astype(np.float64) * x[None, 64:128].astype(np.float64)
    rel = np.abs(prod - exact) / np.abs(exact)
    assert rel.max() < (2.0 ** -21 if passes == 3 else 2.0 ** -10), rel.max()


# ---------------------------------------------------------------------------
# the linear assignment kernel: x . w_k + base_k
# ---------------------------------------------------------------------------
NL, DL, KL = 4000, 64, 32  # config 2's width and K


@pytest.fixture(scope="module", params=["binary", "real"])
def linear_reference(request):
    """Config 2's scores (binary rows around Beta(0.5, 0.5) profiles, W =
    logit p with p clipped at 1e-3, as the bbv draw gives) or the same W on
    real-valued rows, whose TF32 split matters too: X, W, base, the float64
    scores, each row's top two clusters and its tie band."""
    r = np.random.default_rng(1)
    p = np.clip(r.beta(0.5, 0.5, size=(KL, DL)), 1e-3, 1 - 1e-3)
    centers = p[r.integers(0, KL, NL)]
    if request.param == "binary":
        X = (r.random((NL, DL)) < centers).astype(np.float32)
    else:
        X = (centers + r.normal(scale=0.5, size=(NL, DL))).astype(np.float32)
    W = (np.log(p) - np.log1p(-p)).astype(np.float32)
    base = (np.log1p(-p).sum(-1) + np.log(r.dirichlet(np.ones(KL)))).astype(np.float32)
    s64 = X.astype(np.float64) @ W.astype(np.float64).T + base
    top2 = np.argsort(-s64, axis=1)[:, :2]
    band = RTOL * np.abs(np.take_along_axis(s64, top2[:, :1], 1)[:, 0]) + ATOL
    return X, W, base, s64, top2, band


def _linear_error_in_bands(linear_reference, passes):
    X, W, base, s64, top2, band = linear_reference
    s = _products(X, W, passes).astype(np.float64) + base
    return np.abs(np.take_along_axis(s, top2, 1) - np.take_along_axis(s64, top2, 1)).max(1) / band


def test_linear_three_tf32_passes_stay_inside_the_tie_band(linear_reference):
    """3xTF32: every row's top two scores within 1/10 of its band of float64
    (the emulation gives 0.004 on binary rows, 0.03 on real ones)."""
    ratio = _linear_error_in_bands(linear_reference, passes=3)
    assert ratio.max() < 0.1, ratio.max()


def test_linear_one_tf32_pass_leaves_the_tie_band(linear_reference):
    """One TF32 pass misses float64 by more than a whole band on most rows,
    binary or not (W's rounding alone does it: 5 bands at worst on binary
    rows, 22 on real ones in the emulation)."""
    ratio = _linear_error_in_bands(linear_reference, passes=1)
    assert (ratio > 1.0).mean() > 0.5, (ratio > 1.0).mean()
    assert ratio.max() > 3.0, ratio.max()
