"""HDP-LDA topic model (port of `common_tpu/topic/hdp.py`, single device).

Reference analog: the `lda` sibling repo (`lda:microscopes/lda/model.pyx`,
`lda:src/lda/state.cpp`) implements HDP-LDA over `common`'s variadic
dataview with a collapsed direct-assignment Gibbs sampler (Teh et al. 2006
"Hierarchical Dirichlet Processes", §5.3 posterior-representation scheme).

Model (truncated to K topics; truncation error vanishes for K >> K_active):

  beta        ~ stick-break(gamma)          global topic weights  [K+1]
                (last entry = unrepresented remainder mass)
  theta_d     ~ Dirichlet(alpha * beta_1:K) per-doc proportions
  phi_k       ~ Dirichlet(eta)              topic-word dists      [K, V]
  z_t | theta ~ Cat(theta_{d_t});  w_t | z ~ Cat(phi_{z_t})

The corpus is the variadic dataview's flat layout (words [T], doc_ids [T],
mask [T]); word and doc ids are int64 here, torch's index type. Every count
table is a scatter-add over the token axis into a preallocated table with
one scratch slot that masked tokens go to (`torch.bincount` would read its
input's maximum back to the host). Counts are float32, exact up to 2^24 a
slot. Samplers:

  - `collapsed_sweep`: direct-assignment collapsed Gibbs given beta, a
    Python loop over tokens with a [K]-vectorized predictive
    (n_dk^-t + alpha*beta_k)(n_kw^-t + eta)/(n_k^-t + V*eta). The token's
    doc and word come from a host copy of the corpus made once a sweep,
    so no token step waits for the device.
  - `blocked_sweep` and `blocked_sweep_dense`: draw phi | z, theta | z,
    then reassign every token at once (Gumbel-argmax over log theta +
    log phi) and rebuild the counts; the dense form takes a doc-major
    [D, L] corpus and works through it `doc_chunk` docs at a time, each
    chunk one call of `ops.hdp_assign` (on the card one launch of
    `csrc/hdp_assign.cu`, its noise Philox4x32-10 keyed on a seed drawn
    once a sweep; on the CPU its plain version).

`sample_beta` resamples the global weights from Chinese-restaurant-table
counts m_dk = sum_i Bernoulli(a/(a+i)), one [D, K] batch a value of i;
`sample_concentrations` reuses one such draw for alpha, gamma and beta.
Every sampler takes an explicit `torch.Generator` on the state's device.

Over a `parallel.mesh.Mesh` (its data axis), as in the JAX package:

  - `shard_corpus` + `make_sharded_sweep`: tokens sharded, every count
    table replicated; phi and theta drawn alike on every rank from the
    chain's generator, one all_reduce of the three count tables a sweep;
  - `shard_dense_corpus` + `make_sharded_sweep_dense`: docs sharded with
    their z, theta and doc_topic; phi drawn alike on every rank, one
    all_reduce of topic_word a sweep; `sample_beta` and
    `sample_concentrations` take the mesh on this layout.

A rank draws noise only for its own tokens or docs, from its own stream
(`mesh.data_generator`); at one data rank that stream is the chain's
generator, so each sharded sweep then equals its one-device sweep bit for
bit. torch has no global sharded array: each rank holds its shard.

Under `utils.profiling.recording()`: `blocked_sweep_dense` is the span
`hdp.sweep`, its phi and theta draws `hdp.draw`, the docs' score, noise,
argmax and doc counts `hdp.assign` (counter `hdp.doc_chunks`, a chunk of
docs each; on the card also `hdp.fused_assign`, a launch of the kernel
each) and the topic-word count `hdp.topic_word`; `crt_sample` is
`hdp.crt` (counter `hdp.crt_batches`, a Bernoulli batch each), the
Dirichlet draw of beta `hdp.beta`, and `_max_count`'s read of the largest
doc-topic count `read.hdp.max_count`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from common_tpu_torch import validator
from common_tpu_torch.ops.hdp_assign import hdp_assign
from common_tpu_torch.parallel import mesh as mesh_mod
from common_tpu_torch.rng import beta as beta_draw
from common_tpu_torch.rng import device_seed, standard_gamma, uniform_open
from common_tpu_torch.utils import profiling

NOISE_TOKENS = 4096  # tokens whose Gumbel noise the collapsed sweep draws in one call


class TokenData(NamedTuple):
    """Flat corpus: word id, doc id, validity per token slot."""

    words: torch.Tensor    # [T] int64
    doc_ids: torch.Tensor  # [T] int64 (== D for padding slots)
    mask: torch.Tensor     # [T] float32 0/1


def token_data(view) -> TokenData:
    """From a variadic_dataview (or anything with tokens/doc_ids/token_mask)."""
    return TokenData(
        torch.as_tensor(view.tokens).long(),
        torch.as_tensor(view.doc_ids).long(),
        torch.as_tensor(view.token_mask).float(),
    )


@dataclass(frozen=True)
class HDPState:
    """Truncated-HDP latent state (counts are derived but carried)."""

    z: torch.Tensor            # [T] int32 topic per token
    beta: torch.Tensor         # [K+1] global weights (last = remainder)
    doc_topic: torch.Tensor    # [D, K]
    topic_word: torch.Tensor   # [K, V]
    topic_total: torch.Tensor  # [K]
    hypers: Dict[str, torch.Tensor]  # alpha, gamma, eta

    @property
    def n_topics(self) -> int:
        return self.topic_word.shape[0]

    @property
    def n_docs(self) -> int:
        return self.doc_topic.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.topic_word.shape[1]

    def active_topics(self) -> torch.Tensor:
        return (self.topic_total > 0).sum()


def _segment_count(flat: torch.Tensor, n: int) -> torch.Tensor:
    """[n] float32 occurrences of each index in [0, n); index n is the scratch
    slot, dropped."""
    out = torch.zeros(n + 1, dtype=torch.float32, device=flat.device)
    out.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32, device=flat.device))
    return out[:n]


def _counts(z, data: TokenData, D, K, V):
    """All three count tables from (z, corpus), masked tokens in no table
    (and tokens of docs past D in no doc row, as the JAX package drops them)."""
    valid = data.mask > 0
    zi = torch.where(valid, z.long(), K)
    flat_dk = torch.where(valid & (data.doc_ids < D), data.doc_ids * K + zi, D * K)
    flat_kw = torch.where(valid, zi * V + data.words, K * V)
    dk = _segment_count(flat_dk, D * K).view(D, K)
    kw = _segment_count(flat_kw, K * V).view(K, V)
    return dk, kw, kw.sum(-1)


def initialize(view, n_topics: int, vocab_size: int, generator: torch.Generator,
               alpha: float = 1.0, gamma: float = 1.0, eta: float = 0.1,
               n_docs: Optional[int] = None) -> HDPState:
    """Random z and one beta draw (lda's state.initialize analog), on the
    data's device."""
    validator.validate_positive(n_topics, "n_topics")
    validator.validate_positive(vocab_size, "vocab_size")
    data = view if isinstance(view, TokenData) else token_data(view)
    D = int(n_docs) if n_docs is not None else int(view.size())
    dev = data.words.device
    z = torch.randint(0, n_topics, data.words.shape, generator=generator, device=dev, dtype=torch.int32)
    dk, kw, kt = _counts(z, data, D, n_topics, vocab_size)
    scalar = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)  # noqa: E731
    state = HDPState(
        z=z,
        beta=torch.full((n_topics + 1,), 1.0 / (n_topics + 1), dtype=torch.float32, device=dev),
        doc_topic=dk, topic_word=kw, topic_total=kt,
        hypers={"alpha": scalar(alpha), "gamma": scalar(gamma), "eta": scalar(eta)},
    )
    return sample_beta(state, generator)


# ---------------------------------------------------------------------------
# collapsed direct-assignment Gibbs (oracle)
# ---------------------------------------------------------------------------
def collapsed_sweep(state: HDPState, data: TokenData, generator: torch.Generator) -> HDPState:
    """One sequential collapsed sweep over the valid tokens, beta held fixed.

    Masked tokens keep their z and stay out of the counts, as in the JAX
    package; here they are skipped. About 19 launches a token, none waiting
    for the device: one read of the corpus's ids and mask a sweep.
    """
    K, V = state.n_topics, state.vocab_size
    dtype = state.doc_topic.dtype
    ab = state.hypers["alpha"] * state.beta[:K]
    eta = state.hypers["eta"]
    denom_off = V * eta
    z = state.z.clone()
    dk = state.doc_topic.clone()
    kwt = state.topic_word.t().contiguous()  # [V, K]: a word's counts are one row
    kt = state.topic_total.clone()
    slots = torch.arange(K, device=z.device)
    tokens = torch.nonzero(data.mask.cpu() > 0).flatten().tolist()
    words, docs = data.words.cpu().tolist(), data.doc_ids.cpu().tolist()
    for start in range(0, len(tokens), NOISE_TOKENS):
        block = tokens[start:start + NOISE_TOKENS]
        noise = torch.log(-torch.log(uniform_open((len(block), K), generator, dtype)))
        for j, t in enumerate(block):
            dk_d, kw_w = dk[docs[t]], kwt[words[t]]
            old = (slots == z[t]).to(dtype)
            dk_d -= old
            kw_w -= old
            kt -= old
            p = (dk_d + ab) * (kw_w + eta) / (kt + denom_off)
            new = torch.argmax(torch.log(p) - noise[j])
            oh = (slots == new).to(dtype)
            dk_d += oh
            kw_w += oh
            kt += oh
            z[t] = new
    return dataclasses.replace(state, z=z, doc_topic=dk, topic_word=kwt.t().contiguous(), topic_total=kt)


# ---------------------------------------------------------------------------
# beta resampling via CRT table counts
# ---------------------------------------------------------------------------
def crt_sample(generator: torch.Generator, counts, conc, max_count: int) -> torch.Tensor:
    """m ~ CRT(n, a): number of tables from n customers at concentration a.

    m = sum_{i=0}^{n-1} Bernoulli(a / (a + i)), as max_count Bernoulli
    batches of counts' shape, one at a time (exact; zero counts give zero
    tables), their probabilities worked out in one launch. conc broadcasts
    against counts.
    """
    counts = torch.as_tensor(counts, device=generator.device)
    conc = torch.as_tensor(conc, device=counts.device)
    if not conc.is_floating_point():
        conc = conc.float()
    n = int(max_count)
    m = torch.zeros(counts.shape, dtype=torch.int32, device=counts.device)
    profiling.count("hdp.crt_batches", n)
    with profiling.span("hdp.crt"):
        i = torch.arange(n, device=counts.device, dtype=conc.dtype).reshape((n,) + (1,) * conc.dim())
        p = conc / (conc + i)  # [n, ...]: batch i's probability
        for k in range(n):
            b = torch.rand(counts.shape, generator=generator, device=counts.device, dtype=conc.dtype) < p[k]
            m += b & (counts > k)
    return m


def _dirichlet(conc: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Dirichlet draws along the last axis, normalised in log space.

    log G(a) = log G(a + 1) + log(U) / a: at concentrations near 1e-12 a
    plain gamma draw underflows to 0, and a row of zeros (a document with
    no valid token) would normalise to 0/0. In log space every row sums to
    1 and its tiny entries come out as exact zeros.
    """
    log_g = torch.log(standard_gamma(conc + 1.0, generator))
    log_g += torch.log(uniform_open(conc.shape, generator, conc.dtype)) / conc
    return torch.softmax(log_g, dim=-1)


def _beta_from_tables(m_k, gamma, generator):
    """(beta_1..K, beta_rest) ~ Dir(m_1 + 1e-8, ..., m_K + 1e-8, gamma), floored
    at 1e-12 and renormalised (an exact 0 poisons score_joint)."""
    with profiling.span("hdp.beta"):
        beta = _dirichlet(torch.cat([m_k + 1e-8, gamma.reshape(1).to(m_k.dtype)]), generator)
        beta = beta.clamp(min=1e-12)
        return beta / beta.sum()


def _reduce(values, mesh):
    """The sums over the mesh's data ranks (one all_reduce), or the values."""
    return values if mesh is None else mesh_mod.all_reduce_sum(values, mesh.data_group)


def _sample_beta(state: HDPState, generator: torch.Generator, max_count: int, mesh=None) -> HDPState:
    K = state.n_topics
    ab = state.hypers["alpha"] * state.beta[:K]
    stream = generator if mesh is None else mesh_mod.data_generator(mesh, generator)
    m_dk = crt_sample(stream, state.doc_topic, ab[None, :], max_count)
    (m_k,) = _reduce([m_dk.sum(0).to(state.beta.dtype)], mesh)
    return dataclasses.replace(state, beta=_beta_from_tables(m_k, state.hypers["gamma"], generator))


def _max_count(state: HDPState, mesh=None) -> int:
    """The largest doc-topic count (over the data ranks' docs with a mesh), at least 1."""
    top = state.doc_topic.max()
    if mesh is not None:
        top = mesh_mod.all_reduce_max(top, mesh.data_group)
    return max(int(profiling.read(top, "hdp.max_count")), 1)


def sample_beta(state: HDPState, generator: torch.Generator, max_count: Optional[int] = None,
                mesh=None) -> HDPState:
    """beta | z: CRT table counts per (doc, topic), then Dirichlet.

    (beta_1..K, beta_rest) ~ Dir(m_.1, ..., m_.K, gamma), Teh et al. §5.3.
    max_count caps the CRT loop; it defaults to the largest doc-topic count,
    read from the device: pass it in a loop that must not wait.

    mesh: the doc-sharded layout (`shard_dense_corpus`), where each rank
    holds its docs' doc_topic rows. The rank draws its docs' table counts
    from its own stream, the ranks sum m_k in one all_reduce, and beta is
    drawn from `generator`, alike on every rank; max_count defaults to the
    largest count over all ranks.
    """
    return _sample_beta(state, generator, _max_count(state, mesh) if max_count is None else max_count, mesh)


# ---------------------------------------------------------------------------
# concentration resampling (alpha, gamma), Teh et al. 2006 §6 / appendix A
# ---------------------------------------------------------------------------
def _sample_concentrations(state: HDPState, generator: torch.Generator, max_count: int,
                           a_alpha: float, b_alpha: float, a_gamma: float, b_gamma: float,
                           mesh=None) -> HDPState:
    K = state.n_topics
    alpha, gamma = state.hypers["alpha"], state.hypers["gamma"]
    dtype, dev = state.beta.dtype, state.beta.device
    # the per-doc draws: the rank's docs from its own stream on a mesh
    stream = generator if mesh is None else mesh_mod.data_generator(mesh, generator)

    # shared table counts m_dk ~ CRT(n_dk, alpha*beta_k), reused by alpha,
    # gamma and the beta redraw (the §5.3 joint move)
    m_dk = crt_sample(stream, state.doc_topic, (alpha * state.beta[:K])[None, :], max_count)

    # alpha | m, n (auxiliary-variable Gibbs, Teh appendix A):
    # w_d ~ Beta(alpha+1, n_d); s_d ~ Bernoulli(n_d / (n_d + alpha));
    # alpha ~ Gamma(a + m.. - sum s_d, b - sum log w_d); empty docs drop out
    n_d = state.doc_topic.sum(-1).to(dtype)
    has = n_d > 0
    n_safe = n_d.clamp(min=1.0)
    w = beta_draw(torch.broadcast_to(alpha + 1.0, n_safe.shape).contiguous(), n_safe, stream)
    s = torch.rand(n_d.shape, generator=stream, device=dev, dtype=dtype) < n_d / (n_d + alpha)
    m_k, sum_log_w, sum_s = _reduce([
        m_dk.sum(0).to(dtype),
        torch.where(has, torch.log(w.clamp(min=1e-30)), 0.0).sum(),
        (has & s).sum().to(dtype),
    ], mesh)
    m_tot = m_k.sum()
    new_alpha = standard_gamma(a_alpha + m_tot - sum_s, generator) / (b_alpha - sum_log_w)

    # gamma | m (Escobar-West 1995 on the top-level restaurant: m.. customers
    # seated at K+ dishes)
    kplus = (m_k > 0).sum().to(dtype).clamp(min=1.0)
    m_safe = m_tot.clamp(min=1.0)
    eta = beta_draw(gamma + 1.0, m_safe, generator)
    log_eta = torch.log(eta.clamp(min=1e-30))
    odds = (a_gamma + kplus - 1.0) / (m_safe * (b_gamma - log_eta))
    pick_high = torch.rand((), generator=generator, device=dev, dtype=dtype) < odds / (1.0 + odds)
    shape = torch.where(pick_high, a_gamma + kplus, a_gamma + kplus - 1.0)
    new_gamma = standard_gamma(shape, generator) / (b_gamma - log_eta)

    hypers = dict(state.hypers)
    hypers["alpha"] = new_alpha.to(alpha.dtype)
    hypers["gamma"] = new_gamma.to(gamma.dtype)
    return dataclasses.replace(state, beta=_beta_from_tables(m_k, new_gamma, generator), hypers=hypers)


def sample_concentrations(state: HDPState, generator: torch.Generator, max_count: Optional[int] = None,
                          a_alpha: float = 1.0, b_alpha: float = 1.0,
                          a_gamma: float = 1.0, b_gamma: float = 1.0, mesh=None) -> HDPState:
    """Resample (alpha, gamma, beta) | z under Gamma(a, b) hyperpriors.

    One CRT draw of the table counts m_dk feeds (i) the auxiliary-variable
    alpha move over docs, (ii) an Escobar-West gamma move over the top-level
    restaurant (m.. customers, K+ dishes), and (iii) the Dirichlet beta
    redraw. max_count and mesh as in `sample_beta`: with a mesh, m_dk and
    the per-doc auxiliaries w_d, s_d are the rank's docs' (its own stream),
    m_k, sum log w_d and sum s_d are summed over the ranks in one
    all_reduce, and alpha, gamma and beta are drawn alike on every rank.
    """
    return _sample_concentrations(
        state, generator, _max_count(state, mesh) if max_count is None else max_count,
        float(a_alpha), float(b_alpha), float(a_gamma), float(b_gamma), mesh)


# ---------------------------------------------------------------------------
# blocked (uncollapsed) sweeps, the parallel path
# ---------------------------------------------------------------------------
def _draw_phi(state: HDPState, generator: torch.Generator) -> torch.Tensor:
    """phi | z [K, V]."""
    return _dirichlet(state.topic_word + state.hypers["eta"], generator)


def _draw_theta(state: HDPState, generator: torch.Generator) -> torch.Tensor:
    """theta | z, one row a row of doc_topic: Dirichlet draws of K gammas
    each (torch's gamma sampler, normalised in log space)."""
    K = state.n_topics
    return _dirichlet(state.doc_topic + state.hypers["alpha"] * state.beta[:K][None, :], generator)


def _draw_phi_theta(state: HDPState, generator: torch.Generator):
    """phi | z [K, V] and theta | z [D, K]."""
    with profiling.span("hdp.draw"):
        return _draw_phi(state, generator), _draw_theta(state, generator)


def _log_clipped(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p.clamp(min=1e-30))


def _perturbed_argmax(logp: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """argmax over the last axis of logp plus Gumbel noise; logp is consumed
    (the noise is added in place, so a [T, K] table costs two, not four)."""
    u = uniform_open(logp.shape, generator, logp.dtype)
    logp -= u.log_().neg_().log_()  # + Gumbel = - log(-log U)
    return torch.argmax(logp, dim=-1).to(torch.int32)


def _assign_tokens(state: HDPState, data: TokenData, phi, theta, generator: torch.Generator,
                   chunk: Optional[int]) -> torch.Tensor:
    """The tokens' new z given phi and theta: Gumbel-argmax over log theta
    + log phi, `chunk` tokens a table (all at once for None); masked tokens
    keep their z."""
    log_phi_t = _log_clipped(phi).t().contiguous()  # [V, K]
    log_theta = _log_clipped(theta)                 # [D, K]
    T = data.words.shape[0]
    docs = data.doc_ids.clamp(max=state.n_docs - 1)
    step = T if chunk is None or chunk >= T else int(chunk)
    z = torch.empty_like(state.z)
    for a in range(0, T, step):
        b = min(T, a + step)
        logp = log_theta[docs[a:b]]
        logp += log_phi_t[data.words[a:b]]
        z[a:b] = _perturbed_argmax(logp, generator)
        del logp
    return torch.where(data.mask > 0, z, state.z)


def blocked_sweep(state: HDPState, data: TokenData, generator: torch.Generator,
                  chunk: Optional[int] = None) -> HDPState:
    """phi, theta | z, then all tokens reassigned at once.

    chunk: an optional token-block size: the [T, K] score table is then
    built `chunk` tokens at a time, so peak memory is [chunk, K]. Same
    sampler either way.
    """
    phi, theta = _draw_phi_theta(state, generator)
    z = _assign_tokens(state, data, phi, theta, generator, chunk)
    dk, kw, kt = _counts(z, data, state.n_docs, state.n_topics, state.vocab_size)
    return dataclasses.replace(state, z=z, doc_topic=dk, topic_word=kw, topic_total=kt)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def densify_corpus(view, max_len: Optional[int] = None):
    """(words [D, L] int64, mask [D, L] float32) from a ragged variadic_dataview,
    on the view's device.

    Bridges ragged corpora to the dense doc-major path (`blocked_sweep_dense`):
    docs pad to L = max(doc length), or to `max_len`, which truncates longer
    docs (only do that deliberately). One vectorized scatter on the host:
    token t of doc i lands at flat position i*L + (t - ptr[i]).
    """
    ptr = _host(view.row_ptr).astype(np.int64)
    toks = _host(view.tokens)
    lens = np.diff(ptr)
    D = len(lens)
    L = int(lens.max()) if max_len is None else int(max_len)
    keep_len = np.minimum(lens, L)
    mask = (np.arange(L)[None, :] < keep_len[:, None]).astype(np.float32)
    starts = np.repeat(np.arange(D, dtype=np.int64) * L, lens)
    dst = np.arange(ptr[-1], dtype=np.int64) + np.repeat(-ptr[:-1], lens) + starts
    words = np.zeros(D * L, np.int64)
    keep = dst - starts < L
    words[dst[keep]] = toks[:ptr[-1]][keep]
    device = view.tokens.device if torch.is_tensor(view.tokens) else "cpu"
    return (torch.from_numpy(words.reshape(D, L)).to(device), torch.from_numpy(mask).to(device))


def dense_token_data(words, mask=None) -> TokenData:
    """TokenData from a rectangular doc-major [D, L] corpus (docs padded to
    equal length; mask 0 = padding), on the words' device. The flat token
    order is row-major, so a state initialized from this view is
    layout-compatible with `blocked_sweep_dense`."""
    words = torch.as_tensor(words).long()
    D, L = words.shape
    mask = torch.ones((D, L), device=words.device) if mask is None else torch.as_tensor(mask, device=words.device)
    doc_ids = torch.arange(D, device=words.device)[:, None].expand(D, L).reshape(-1)
    return TokenData(words.reshape(-1), doc_ids, mask.float().reshape(-1))


def blocked_sweep_dense(state: HDPState, words, mask, generator: torch.Generator,
                        doc_chunk: Optional[int] = None) -> HDPState:
    """Rectangular doc-major form of `blocked_sweep`.

    words/mask: [D, L] (docs padded to equal length; the state must have
    been initialized from `dense_token_data(words, mask)` so `state.z` is
    row-major-flat). The same sampler, but theta is read per doc instead of
    gathered per token, and doc_topic is counted over each doc's L tokens.
    doc_chunk sets the docs a call of `ops.hdp_assign` takes (doc_chunk=None:
    about 2^26 / (L K) docs, the JAX default); the draws do not depend on
    it. On the card no [doc_chunk, L, K] table is made; on the CPU the plain
    version makes one a chunk.
    """
    with profiling.span("hdp.sweep"):
        phi, theta = _draw_phi_theta(state, generator)
        z, dk, kw = _assign_docs(state, words, mask, phi, theta, generator, doc_chunk)
        return dataclasses.replace(state, z=z, doc_topic=dk, topic_word=kw, topic_total=kw.sum(-1))


def _assign_docs(state: HDPState, words, mask, phi, theta, generator: torch.Generator,
                 doc_chunk: Optional[int]):
    """The docs' new z [D * L] given phi and theta [D, K], `doc_chunk` docs a
    call of `ops.hdp_assign` (on the card one kernel launch, which never
    writes the [doc_chunk, L, K] score table), with their doc_topic [D, K]
    and topic_word [K, V] counts. The noise's seed is drawn once a call, so
    the chunking changes no draw."""
    D, L = words.shape
    K, V = state.n_topics, state.vocab_size
    log_phi_t = _log_clipped(phi).t().contiguous()  # [V, K], a word's scores one row
    log_theta = _log_clipped(theta)                 # [D, K]
    step = min(D, max(1024, (1 << 26) // max(L * K, 1)) if doc_chunk is None else int(doc_chunk))
    seed = device_seed(generator, words.device)
    z_old = state.z.view(D, L)
    z = torch.empty_like(z_old)
    dk = torch.empty((D, K), dtype=torch.float32, device=z.device)
    chunks = -(-D // step)
    profiling.count("hdp.doc_chunks", chunks)
    if words.is_cuda:
        profiling.count("hdp.fused_assign", chunks)
    with profiling.span("hdp.assign"):
        for a in range(0, D, step):
            b = min(D, a + step)
            hdp_assign(words[a:b], mask[a:b], z_old[a:b], log_theta[a:b], log_phi_t, seed, doc0=a,
                       out=(z[a:b], dk[a:b]))
    z = z.reshape(-1)
    with profiling.span("hdp.topic_word"):
        flat_kw = torch.where(mask.reshape(-1) > 0, z.long() * V + words.reshape(-1), K * V)
        return z, dk, _segment_count(flat_kw, K * V).view(K, V)


# ---------------------------------------------------------------------------
# multi-device: token- and doc-sharded blocked sweeps over a Mesh
# ---------------------------------------------------------------------------
def _on(state: HDPState, device) -> HDPState:
    return dataclasses.replace(
        state, **{f.name: getattr(state, f.name).to(device) for f in dataclasses.fields(state)
                  if f.name != "hypers"},
        hypers={k: v.to(device) for k, v in state.hypers.items()})


def shard_corpus(mesh, state: HDPState, data: TokenData):
    """This rank's shard of the token-sharded layout, on the mesh's device:
    its contiguous slice of the token axis of `data` and of `state.z`;
    every other leaf (the count tables, beta, hypers) whole, replicated.

    The token count must divide over the data ranks (ValueError); pad with
    masked tokens first (`variadic_dataview(pad_to=...)`).
    """
    a, b = mesh_mod._span(data.words.shape[0], mesh.data, mesh.data_index, "tokens")
    local = TokenData(*(t[a:b].to(mesh.device).contiguous() for t in data))
    state = _on(state, mesh.device)
    return dataclasses.replace(state, z=state.z[a:b].contiguous()), local


def make_sharded_sweep(mesh, state: HDPState, data: TokenData):
    """The token-sharded blocked sweep: (state, data_blk, generator,
    chunk=None) -> state, on this rank (`shard_corpus`'s layout).

    phi and theta are drawn from `generator`, seeded alike on every data
    rank, so they agree without a broadcast; the rank scores and reassigns
    its tokens `chunk` at a time as `blocked_sweep` does, its Gumbel noise
    from its own stream; the three count tables of its tokens (global doc
    ids) are summed over the data ranks in one all_reduce. Every rank must
    hold the same number of tokens: checked here with one all_gather.
    """
    n_local = data.words.shape[0]
    if state.z.shape[0] != n_local:
        raise ValueError(f"z holds {state.z.shape[0]} tokens, the data {n_local}")
    mesh_mod.require_equal_shards(mesh, n_local, "token")
    D, K, V = state.n_docs, state.n_topics, state.vocab_size

    def sweep(state: HDPState, data_blk: TokenData, generator: torch.Generator,
              chunk: Optional[int] = None) -> HDPState:
        phi, theta = _draw_phi_theta(state, generator)
        z = _assign_tokens(state, data_blk, phi, theta, mesh_mod.data_generator(mesh, generator), chunk)
        dk, kw, kt = mesh_mod.all_reduce_sum(list(_counts(z, data_blk, D, K, V)), mesh.data_group)
        return dataclasses.replace(state, z=z, doc_topic=dk, topic_word=kw, topic_total=kt)

    return sweep


def shard_dense_corpus(mesh, state: HDPState, words, mask):
    """This rank's shard of the doc-sharded layout, on the mesh's device:
    (state, words, mask) with its contiguous block of docs of `words`,
    `mask`, `state.z` and `state.doc_topic`; topic_word, topic_total, beta
    and hypers whole, replicated.

    The doc count must divide over the data ranks (ValueError); pad with
    empty docs first. The state must come from `dense_token_data(words,
    mask)`, so z is row-major over [D, L].
    """
    D, L = words.shape
    a, b = mesh_mod._span(D, mesh.data, mesh.data_index, "docs")
    state = _on(state, mesh.device)
    state = dataclasses.replace(state, z=state.z[a * L:b * L].contiguous(),
                                doc_topic=state.doc_topic[a:b].contiguous())
    dev = mesh.device
    return (state, torch.as_tensor(words)[a:b].to(dev).contiguous(),
            torch.as_tensor(mask)[a:b].to(dev).contiguous())


def make_sharded_sweep_dense(mesh, state: HDPState, words, mask):
    """The doc-sharded dense sweep: (state, words_blk, mask_blk, generator,
    doc_chunk=None) -> state, on this rank (`shard_dense_corpus`'s layout).

    phi is drawn from `generator`, alike on every data rank; theta only for
    the rank's docs, from its own stream, which then gives their Gumbel
    noise; the rank's docs are reassigned `doc_chunk` at a time as in
    `blocked_sweep_dense`, their doc_topic stays local, and topic_word is
    summed over the data ranks in one all_reduce (topic_total is its row
    sums). Every rank must hold the same number of docs: checked here
    with one all_gather.
    """
    d_loc, L = words.shape
    if state.doc_topic.shape[0] != d_loc or state.z.shape[0] != d_loc * L:
        raise ValueError(f"the state holds {state.doc_topic.shape[0]} docs, the corpus {d_loc} of {L} tokens")
    mesh_mod.require_equal_shards(mesh, d_loc, "doc")

    def sweep(state: HDPState, words_blk, mask_blk, generator: torch.Generator,
              doc_chunk: Optional[int] = None) -> HDPState:
        phi = _draw_phi(state, generator)
        stream = mesh_mod.data_generator(mesh, generator)
        theta = _draw_theta(state, stream)
        z, dk, kw = _assign_docs(state, words_blk, mask_blk, phi, theta, stream, doc_chunk)
        (kw,) = mesh_mod.all_reduce_sum([kw], mesh.data_group)
        return dataclasses.replace(state, z=z, doc_topic=dk, topic_word=kw, topic_total=kw.sum(-1))

    return sweep


# ---------------------------------------------------------------------------
# scoring / diagnostics
# ---------------------------------------------------------------------------
def score_joint(state: HDPState) -> torch.Tensor:
    """log p(z, w | beta, hypers): Dirichlet-multinomial in both blocks.

    sum_d log DM(n_d. | alpha*beta) + sum_k log DM(n_k. | eta 1_V), the
    joint-score trace (the reference's score_assignment + score_data).
    """
    K, V = state.n_topics, state.vocab_size
    alpha, eta = state.hypers["alpha"], state.hypers["eta"]
    ab = alpha * state.beta[:K]
    dk = state.doc_topic
    a0 = ab.sum()
    doc_term = (torch.lgamma(a0) - torch.lgamma(a0 + dk.sum(-1))
                + (torch.lgamma(dk + ab[None, :]) - torch.lgamma(ab)[None, :]).sum(-1)).sum()
    kw = state.topic_word
    word_term = (torch.lgamma(V * eta) - torch.lgamma(V * eta + state.topic_total)
                 + (torch.lgamma(kw + eta) - torch.lgamma(eta)).sum(-1)).sum()
    return doc_term + word_term


def perplexity(state: HDPState, data: TokenData) -> torch.Tensor:
    """exp(-mean predictive log-lik per token) under posterior-mean phi/theta."""
    K = state.n_topics
    eta, alpha = state.hypers["eta"], state.hypers["alpha"]
    phi_t = ((state.topic_word + eta) / (state.topic_total + state.vocab_size * eta)[:, None]).t()
    conc = state.doc_topic + alpha * state.beta[:K][None, :]
    theta = conc / conc.sum(-1, keepdim=True)
    docs = data.doc_ids.clamp(max=state.n_docs - 1)
    p = (theta[docs] * phi_t[data.words]).sum(-1)
    ll = (torch.log(p.clamp(min=1e-30)) * data.mask).sum()
    return torch.exp(-ll / data.mask.sum().clamp(min=1.0))
