"""The dense HDP sweep's score-and-assign (`ops/hdp_assign.py`, `csrc/hdp_assign.cu`).

On the CPU the plain version is held to a float64 argmax of log theta + log
phi + Gumbel noise worked out here from the Philox counters (token, k // 4,
token >> 32, 3); the chunks of `topic/hdp.py` `_assign_docs` give the same z
as one call over all docs; masked tokens keep z and are counted nowhere; the
doc and topic-word counts equal an int64 recount. The tests marked `cuda`
hold the kernel to the plain version bit for bit on the card (z and the doc
counts) and skip without one. The file imports no JAX, so on the card:

    python -m pytest tests/test_torch_hdp_assign.py --noconftest -q
"""

import dataclasses

import pytest
import torch

from common_tpu_torch import rng, topic
from common_tpu_torch.ops import hdp_assign as ha
from common_tpu_torch.ops.philox import philox4x32_10
from common_tpu_torch.topic import hdp

V = 23
SEED = 2**31 - 77
TIE = 1e-3  # float32 scores of magnitude under 200 round well inside it


def _problem(D, L, K, theta, seed, device="cpu"):
    """words, mask (about a fifth masked), z_old, log theta, log phi^T, seed.

    theta "spread": log theta of every topic within a few nats; "peaked":
    one or two topics a doc, the rest near the 1e-30 clamp, where the kernel
    draws noise only for the topics within reach."""
    g = torch.Generator().manual_seed(seed)
    words = torch.randint(0, V, (D, L), generator=g)
    mask = (torch.rand((D, L), generator=g) > 0.2).float()
    z_old = torch.randint(0, K, (D, L), generator=g, dtype=torch.int32)
    log_phi_t = torch.log_softmax(3.0 * torch.randn((K, V), generator=g), dim=-1).t().contiguous()
    if theta == "spread":
        log_theta = torch.randn((D, K), generator=g)
    else:
        log_theta = torch.full((D, K), -69.0776)
        top = torch.randint(0, K, (D, 2), generator=g)
        log_theta.scatter_(1, top, torch.log(torch.rand((D, 2), generator=g) * 0.9 + 0.05))
    s = torch.tensor([seed % (2**31 - 1)], dtype=torch.int32)
    return [t.to(device) for t in (words, mask, z_old, log_theta, log_phi_t, s)]


def _float64_scores(words, log_theta, log_phi_t, seed, doc0):
    """[D, L, K] float64 scores with the kernel's noise rebuilt from its counters."""
    D, L = words.shape
    K = log_phi_t.shape[1]
    tok = ((doc0 + torch.arange(D))[:, None] * L + torch.arange(L)).reshape(-1, 1).expand(-1, K)
    k = torch.arange(K)[None, :].expand_as(tok)
    ctr = (tok & 0xFFFFFFFF, k // 4, tok >> 32, torch.full_like(tok, 3))
    out = philox4x32_10(ctr, (int(seed) & 0xFFFFFFFF, 0x5EED))
    bits = torch.stack(out, -1).gather(-1, (k % 4)[..., None])[..., 0]
    u = ((bits >> 8).double() / 16777216.0).clamp(min=1e-7)
    gumbel = -torch.log(-torch.log(u))
    return (log_theta.double()[:, None, :] + log_phi_t.double()[words]
            + gumbel.view(D, L, K))


def _recount(z, words, mask, K):
    valid = mask > 0
    D = words.shape[0]
    dk = torch.zeros((D, K), dtype=torch.int64)
    kw = torch.zeros((K, V), dtype=torch.int64)
    for d, l in valid.nonzero().tolist():
        dk[d, z[d, l]] += 1
        kw[z[d, l], words[d, l]] += 1
    return dk, kw


CASES = [(K, L) for K in (2, 5, 32, 37) for L in (1, 3, 50)]


@pytest.mark.parametrize("K,L", CASES)
@pytest.mark.parametrize("theta", ["spread", "peaked"])
def test_plain_is_the_float64_argmax_of_the_kernels_noise(K, L, theta):
    """Every valid token's z is the float64 argmax outside the float32 tie
    band; masked tokens keep z_old; the doc counts are an int64 recount."""
    D, doc0 = 13, 1234
    words, mask, z_old, lt, lp, seed = _problem(D, L, K, theta, K * 100 + L)
    z, dk = ha.hdp_assign_plain(words, mask, z_old, lt, lp, seed, doc0)
    assert z.dtype == torch.int32 and dk.dtype == torch.float32 and dk.shape == (D, K)
    s64 = _float64_scores(words, lt, lp, seed, doc0)
    top2 = s64.topk(2, dim=-1).values
    tie = top2[..., 0] - top2[..., 1] <= TIE
    valid = mask > 0
    assert int((tie & valid).sum()) <= max(1, 0.01 * int(valid.sum()))
    keep = valid & ~tie
    assert torch.equal(z[keep].long(), s64.argmax(-1)[keep])
    assert torch.equal(z[~valid], z_old[~valid])
    want_dk, _ = _recount(z, words, mask, K)
    assert torch.equal(dk.to(torch.int64), want_dk)


@pytest.mark.parametrize("K,L", CASES)
@pytest.mark.parametrize("doc_chunk", [1, 7, None])
def test_doc_chunks_give_the_same_z_and_counts(K, L, doc_chunk):
    """`_assign_docs` over chunks of 1 or 7 docs, or all at once, equals one
    plain call over the corpus with the seed the sweep's generator draws;
    its doc_topic and topic_word equal an int64 recount."""
    D = 17
    words, mask, z_old, _, _, _ = _problem(D, L, K, "spread", 7 * K + L)
    data = topic.dense_token_data(words, mask)
    s = topic.initialize(data, K, V, rng(3, "cpu").generator, n_docs=D)
    s = dataclasses.replace(s, z=z_old.reshape(-1))
    phi, theta = hdp._draw_phi_theta(s, rng(4, "cpu").generator)
    g = rng(5, "cpu").generator
    z, dk, kw = hdp._assign_docs(s, words, mask, phi, theta, g, doc_chunk)
    seed = torch.randint(0, 2**31 - 1, (1,), generator=rng(5, "cpu").generator, dtype=torch.int32)
    want_z, want_dk = ha.hdp_assign_plain(words, mask, z_old, hdp._log_clipped(theta),
                                          hdp._log_clipped(phi).t().contiguous(), seed)
    assert torch.equal(z.view(D, L), want_z) and torch.equal(dk, want_dk)
    assert torch.equal(z.view(D, L)[mask == 0], z_old[mask == 0])
    want_dk, want_kw = _recount(z.view(D, L), words, mask, K)
    assert torch.equal(dk.to(torch.int64), want_dk) and torch.equal(kw.to(torch.int64), want_kw)
    assert int(dk.sum()) == int(kw.sum()) == int(mask.sum())


def test_the_noise_counter_words():
    """Token t, topic k draws word k % 4 of the call with counter
    (t mod 2^32, k // 4, t >> 32, 3): a stream apart from the linear
    kernel's (last word 1), and tokens past 2^32 use the third word."""
    seed = torch.tensor([SEED % (2**31 - 1)], dtype=torch.int32)
    tokens = torch.tensor([0, 5, 2**32 - 1, 2**32 + 5, 3 * 2**32 + 7])
    got = ha.hdp_philox_gumbel(seed, tokens, 7).double()
    for i, t in enumerate(tokens.tolist()):
        for k in range(7):
            ctr = tuple(torch.tensor([v]) for v in (t % 2**32, k // 4, t >> 32, 3))
            bits = philox4x32_10(ctr, (int(seed), 0x5EED))[k % 4]
            u = ((bits >> 8).double() / 16777216.0).clamp(min=1e-7)
            # float32 logs against float64 ones: a wrong word would be off by nats
            torch.testing.assert_close(got[i, k:k + 1], -torch.log(-torch.log(u)), rtol=1e-6, atol=1e-6)
    assert not torch.equal(got[3], got[1])  # 2^32 + 5 is not token 5
    from common_tpu_torch.ops.linear_assign import linear_philox_gumbel
    assert not torch.equal(got[:2].float(), linear_philox_gumbel(seed, tokens[:2], 7))


def test_the_wrapper_refuses_what_it_does_not_take():
    words, mask, z_old, lt, lp, seed = _problem(4, 3, 5, "spread", 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        ha.hdp_assign(words, mask[:, :2], z_old, lt, lp, seed)
    with pytest.raises(ValueError, match="shape mismatch"):
        ha.hdp_assign(words, mask, z_old, lt[:, :4], lp, seed)
    with pytest.raises(ValueError, match="one value"):
        ha.hdp_assign(words, mask, z_old, lt, lp, seed.repeat(2))
    with pytest.raises(ValueError, match="is on meta"):
        ha.hdp_assign(words, mask, z_old, lt, lp, seed.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ha.hdp_assign(*(t.to("meta") for t in (words, mask, z_old, lt, lp, seed)))
    z, dk = torch.empty_like(z_old), torch.empty_like(lt)
    assert ha.hdp_assign(words, mask, z_old, lt, lp, seed, out=(z, dk))[0] is z
    assert torch.equal(z, ha.hdp_assign_plain(words, mask, z_old, lt, lp, seed)[0])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K,L", CASES + [(5, 257), (32, 600)])
@pytest.mark.parametrize("theta", ["spread", "peaked"])
def test_cuda_kernel_equals_plain_bit_for_bit(cuda_device, K, L, theta):
    """z and the doc counts of one launch equal the plain version's on the
    card, at doc offset 0 and past 2^32 tokens; docs longer than a block's
    256 threads take a block each."""
    D = 301
    words, mask, z_old, lt, lp, seed = _problem(D, L, K, theta, K + 1000 * L, cuda_device)
    for doc0 in (0, 2**32 // L + 5):
        before = ha.hdp_assign.launches
        z, dk = ha.hdp_assign(words, mask, z_old, lt, lp, seed, doc0)
        assert ha.hdp_assign.launches == before + 1
        want_z, want_dk = ha.hdp_assign_plain(words, mask, z_old, lt, lp, seed, doc0)
        assert torch.equal(z, want_z), int((z != want_z).sum())
        assert torch.equal(dk, want_dk)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device):
    words, mask, z_old, lt, lp, seed = _problem(8, 3, 5, "spread", 2, cuda_device)
    bad = {"mask": (words, mask.double(), z_old, lt, lp, seed),
           "words": (words.int(), mask, z_old, lt, lp, seed),
           "seed": (words, mask, z_old, lt, lp, seed.long()),
           "log_phi_t": (words, mask, z_old, lt, lp.t().contiguous().t(), seed)}
    for name, args in bad.items():
        with pytest.raises(ValueError, match=name):
            ha.hdp_assign(*args)
    K = ha.MAX_TOPICS + 1
    wide = (words, mask, z_old, torch.zeros((8, K), device=cuda_device), torch.zeros((V, K), device=cuda_device),
            seed)
    with pytest.raises(ValueError, match="at most"):
        ha.hdp_assign(*wide)
    assert ha.MAX_TOPICS == ha._build.library().hdp_assign_max_topics()
