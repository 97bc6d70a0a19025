"""The infinite relational model's conditionals, written from Kemp, Tenenbaum, Griffiths, Yamada and
Ueda (2006), "Learning systems of concepts with an infinite relational model", §2, for a blocked
sweep of one Beta-Bernoulli relation between two domains.

The model: each domain d's partition z_d ~ CRP(alpha_d); each block (k, l) of the two partitions
has eta_kl ~ Beta(a, b); each observed cell R_ij ~ Bernoulli(eta_{z0_i z1_j}). With the block
counts n_kl (observed cells in block (k, l)) and h_kl (ones among them), Beta-Bernoulli conjugacy
gives

    eta_kl | z, R ~ Beta(a + h_kl, b + n_kl - h_kl),
    p(z0_i = k | eta, z1, w) ∝ w_k prod_j eta_{k z1_j}^R_ij (1 - eta_{k z1_j})^(1 - R_ij),

the product over entity i's observed cells, and alike for z1_j given eta and z0. An entity's log
conditional is a sum over the other domain's clusters l of H_il log eta_kl + T_il log(1 -
eta_kl), H and T its ones and zeros among the cells whose other entity sits in l: one [N_d, K]
product of counts with log eta a domain (`table`). The joint score, eta integrated out, is each
domain's CRP EPPF, K+ log alpha + sum_k lgamma(n_k) + lgamma(alpha) - lgamma(alpha + N), plus over
the blocks betaln(a + h, b + n - h) - betaln(a, b).

Departures from the paper, each the program's:

- the truncation at K slots a domain, with the blocked sampler's stick-breaking weights w
  (Ishwaran & James 2001; `sticks.py`) in place of the CRP's sequential seating;
- the blocked sweep: eta | z, then z0 | eta, z1, then z1 | eta and the new z0 (the paper moves
  one entity at a time with eta integrated out);
- eta drawn inside (0, 1) of float32 (clamped to [tiny, 1 - eps / 2]); the reference takes eta
  as the program drew it;
- the hypers held fixed (the paper samples them);
- a cell with mask 0 (missing) is in no count, no table and no score.

Everything takes the relation dense, x [N0, N1] zeros and ones and its mask [N0, N1], and works
in blocks of rows. The precision is `REFERENCE` (float64) or `CONTROL`, bfloat16 operands with
float32 sums (a bfloat16 tensor-core product), put in the program's place.

The statistics that judge a draw:

- `beta_fit_t`: Beta draws against their parameters, the larger of the standardised sum of
  (x - mean) / sd and the two-group `hdp.DirichletFit` of (x, 1 - x) (the second catches a
  draw too spread or too narrow, the first a shifted one); each about abs(N(0, 1)) for exact
  draws.
- `assign_fit_t`: categorical draws against their probabilities by the randomised probability
  integral transform over the candidates ranked by falling probability: u = the mass ranked
  before the drawn candidate plus a uniform share of its own is U(0, 1) for an exact draw.
  It reads the larger of the standardised sum of u - 1/2 and the normal quantile of the
  smallest 1 - u among n (a draw of a candidate far less probable than the rest reads
  infinity); about abs(N(0, 1)) for exact draws, and sound where most entities' conditionals
  are nearly certain, as they are once the clusters form.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import bbv as ref_bbv
from benchmark.reference.hdp import SCORES_CONTROL, DirichletFit, blocks
from benchmark.reference.precision import REFERENCE, Precision

ROWS = 1024  # rows of the relation in a block of the reference
CONTROL = SCORES_CONTROL  # bfloat16 operands, float32 arithmetic
F64 = torch.float64


def onehot(z: torch.Tensor, K: int) -> torch.Tensor:
    """[N, K] float64 indicator of each entity's cluster."""
    return torch.nn.functional.one_hot(z.to(torch.int64), K).to(F64)


def _domain_view(x: torch.Tensor, mask: torch.Tensor, domain: int):
    """(x, mask) with domain `domain`'s entities on the rows."""
    return (x, mask) if domain == 0 else (x.T, mask.T)


def entity_counts(z_other: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, K_other: int, domain: int,
                  lo: int, hi: int):
    """(H, T) [hi - lo, K_other] float64: ones and zeros of entities lo..hi-1 of `domain` among
    their observed cells, by the other domain's cluster. Exact integers."""
    xd, md = _domain_view(x, mask, domain)
    xb, mb = xd[lo:hi].to(F64), md[lo:hi].to(F64)
    oh = onehot(z_other, K_other)
    return (xb * mb) @ oh, ((1.0 - xb) * mb) @ oh


def block_counts(z0: torch.Tensor, z1: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, K0: int, K1: int):
    """(n [K0, K1], h [K0, K1]) int64: observed cells and ones in each block."""
    n = torch.zeros((K0, K1), dtype=F64, device=x.device)
    h = torch.zeros_like(n)
    for lo, hi in blocks(x.shape[0], ROWS):
        ones, zeros = entity_counts(z1, x, mask, K1, 0, lo, hi)
        oh = onehot(z0[lo:hi], K0).T
        h += oh @ ones
        n += oh @ (ones + zeros)
    return n.to(torch.int64), h.to(torch.int64)


def assignment_counts(z: torch.Tensor, K: int) -> torch.Tensor:
    """[K] int64 entities in each slot (slots out of range are not counted)."""
    zl = z.to(torch.int64)
    return torch.bincount(zl[(zl >= 0) & (zl < K)], minlength=K)


def theta_params(n: torch.Tensor, h: torch.Tensor, a, b):
    """(A, B) float64: eta_kl | z, R ~ Beta(A_kl, B_kl)."""
    n, h = n.to(F64), h.to(F64)
    return float(a) + h, float(b) + n - h


def beta_draw(A: torch.Tensor, B: torch.Tensor, generator: torch.Generator, p: Precision) -> torch.Tensor:
    """Beta(A, B) draws, a ratio of Gamma draws with the arithmetic in p (the control's draw)."""
    ga = p(torch._standard_gamma(A, generator=generator))
    gb = p(torch._standard_gamma(B, generator=generator))
    return p(ga / p(ga + gb))


def table(z_other: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, theta: torch.Tensor, domain: int,
          p: Precision = REFERENCE) -> torch.Tensor:
    """[N_d, K_d] log p(domain d's entity's observed cells | it in cluster k, eta, z_other),
    the products in p (float64 for the reference)."""
    th = theta.to(F64) if domain == 0 else theta.to(F64).T  # [K_d, K_other]
    log_on, log_off = torch.log(th), torch.log1p(-th)
    n_d = x.shape[domain]
    out = []
    for lo, hi in blocks(n_d, ROWS):
        ones, zeros = entity_counts(z_other, x, mask, th.shape[1], domain, lo, hi)
        out.append(p(p.mm(ones, log_on.T) + p.mm(zeros, log_off.T)))
    return torch.cat(out).to(F64)


def eppf(counts: torch.Tensor, alpha, p: Precision) -> torch.Tensor:
    """log p(partition) of one domain under the CRP."""
    return ref_bbv.crp_log_prob(counts.to(F64), torch.tensor(float(alpha), dtype=F64, device=counts.device), p)


def score_joint(z0: torch.Tensor, z1: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, K0: int, K1: int,
                a, b, alphas, p: Precision) -> float:
    """log p(z0, z1, R): both domains' EPPF and each block's Beta-Bernoulli marginal, each term in
    p and summed in p's dtype."""
    n, h = block_counts(z0, z1, x, mask, K0, K1)
    av = torch.tensor(float(a), dtype=F64, device=x.device)
    bv = torch.tensor(float(b), dtype=F64, device=x.device)
    n, h = n.to(F64), h.to(F64)

    def betaln(u, v):
        return p(p(torch.lgamma(u)) + p(torch.lgamma(v)) - p(torch.lgamma(u + v)))

    blocks_ml = p(betaln(av + h, bv + n - h) - betaln(av, bv)).sum()
    crp = sum(eppf(assignment_counts(z, K), alpha, p) for z, K, alpha in ((z0, K0, alphas[0]), (z1, K1, alphas[1])))
    return float(p(blocks_ml) + p(crp))


def assign_draw(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[N] argmax of the logits plus float64 Gumbel noise (the control's draw)."""
    u = torch.rand(logits.shape, generator=generator, dtype=F64, device=logits.device)
    u = u.clamp(torch.finfo(F64).tiny, 1.0 - torch.finfo(F64).eps)
    return torch.argmax(logits.to(F64) - torch.log(-torch.log(u)), dim=-1)


# ---------------------------------------------------------------------------
# the statistics that judge a draw
# ---------------------------------------------------------------------------
def beta_shift_z(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> float:
    """The sum of (x - mean) / sd of draws x ~ Beta(A, B) over sqrt(n): N(0, 1) for exact draws."""
    x, A, B = x.to(F64).reshape(-1), A.reshape(-1), B.reshape(-1)
    c = A + B
    return float(((x - A / c) / (A * B / (c * c * (c + 1.0))).sqrt()).sum()) / math.sqrt(x.numel())


def beta_fit_t(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> float:
    """Draws x ~ Beta(A, B) (each entry its own): see the module."""
    x, A, B = x.to(F64).reshape(-1), A.reshape(-1), B.reshape(-1)
    fit = DirichletFit()
    fit.add(torch.stack([x, 1.0 - x], -1), torch.stack([A, B], -1),
            torch.ones((x.numel(), 2), dtype=torch.bool, device=x.device), 2)
    return max(abs(beta_shift_z(x, A, B)), fit.t())


def pit(logits: torch.Tensor, z: torch.Tensor, generator: torch.Generator):
    """(u, 1 - u) [N] of draws z [N] in range from softmax(logits [N, K]): u is the mass of the
    candidates ranked before z (more probable, or as probable at a lower index) plus a uniform
    share of z's own, U(0, 1) for an exact draw; 1 - u is summed from the mass after it, so it
    keeps its digits where u lies near 1."""
    z = z.to(torch.int64)
    q = torch.softmax(logits.to(F64), -1)
    qz = q.gather(1, z[:, None])
    k = torch.arange(q.shape[1], device=q.device)[None, :]
    before = (q > qz) | ((q == qz) & (k < z[:, None]))
    after = ~before & (k != z[:, None])
    v = torch.rand(q.shape[0], generator=generator, dtype=F64, device=q.device)
    qz = qz[:, 0]
    return (q * before).sum(-1) + v * qz, (q * after).sum(-1) + (1.0 - v) * qz


def assign_fit_t(logits: torch.Tensor, z: torch.Tensor, generator: torch.Generator) -> float:
    """Draws z [N] from softmax(logits [N, K]) (float64): see the module. A slot out of range reads
    infinity."""
    N, K = logits.shape
    if bool(((z < 0) | (z >= K)).any()):
        return math.inf
    u, rest = pit(logits, z, generator)
    t_mean = abs(float((u - 0.5).sum())) / math.sqrt(N / 12.0)
    p_min = -torch.expm1(N * torch.log1p(-rest.min()))  # P(the least of N uniforms <= it)
    return max(t_mean, -float(torch.special.ndtri(p_min / 2.0)))
