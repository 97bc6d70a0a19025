"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from common_tpu_torch.ops import gaussian_assign as ga
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
    v = ga.philox_scores(*t, seed)
    top2, arg = v.topk(2, dim=-1)
    tie = (top2[:, 0] - top2[:, 1]) <= 3e-5 * top2[:, 0].abs() + 1e-3
    assert int(tie.sum()) <= 0.01 * n
    assert torch.equal(z[~tie], arg[~tie, 0])


@pytest.mark.cuda
def test_cuda_scatter_kernel_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    X = torch.randn(20011, 72, generator=g, device=cuda_device)
    z = torch.randint(-1, 10, (20011,), generator=g, device=cuda_device, dtype=torch.int32)
    got = ss.fused_scatter_stats(X, z, 9)
    want = ss.scatter_stats_plain(X, z, 9)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
