"""HDP-LDA's conditionals, written from Teh, Jordan, Beal and Blei (2006), "Hierarchical
Dirichlet Processes", §5.3 (the posterior representation sampler), for a blocked sweep.

The model, truncated to K topics: global weights beta ~ GEM(gamma), seen as
(beta_1..K, beta_rest); per document theta_d ~ Dir(alpha beta_1..K); per topic
phi_k ~ Dir(eta 1_V); a token's topic z ~ Cat(theta_d) and its word w ~
Cat(phi_z). With counts n_dk (tokens of doc d in topic k) and n_kw (tokens of
word w in topic k) of the assignments z, the blocked sweep's conditionals are

    phi_k | z ~ Dir(n_k. + eta),   theta_d | z, beta ~ Dir(n_d. + alpha beta_1..K),
    p(z_t = k | phi, theta) = theta_dk phi_kw / sum_j theta_dj phi_jw,

the table counts m_dk ~ CRT(n_dk, alpha beta_k), that is sum_{i < n_dk} of
Bernoulli(alpha beta_k / (alpha beta_k + i)), and beta | m ~ Dir(m_.1, ...,
m_.K, gamma). The joint score of (z, w) given beta is two Dirichlet-multinomial
blocks: sum_d log DM(n_d. | alpha beta_1..K) + sum_k log DM(n_k. | eta 1_V),
each of an ordered sequence (no multinomial coefficient).

Departures from the published model, each the program's:

- the truncation at K topics: theta_d has K entries, the remainder mass
  beta_rest only enters beta's draw;
- beta_k is floored at 1e-12 after its draw and renormalised, so that every
  alpha beta_k is positive; the reference takes beta as the program drew it;
- m_k + 1e-8 in beta's Dirichlet, so that an empty topic keeps a positive
  parameter (`beta_params`).

Masked (held-out) tokens are in no count and keep their topic. Everything
works in blocks of documents and takes a `Precision`: float64 for the
reference; the control puts bfloat16 scores (`SCORES_CONTROL`) and float16
CRT probabilities (`CRT_CONTROL`) in the program's place.

The statistics that judge a draw, each about abs(N(0, 1)) for an exact one:

- `DirichletFit`: a Dirichlet row's entries summed over groups fixed by the
  parameters (every occupied entry alone, the empty ones `chunk` at a time,
  a group under `A_MIN` merged into the row's first occupied entry) are
  Dirichlet with the groups' summed parameters (the aggregation property).
  Q = (c + 1) sum_g (X_g - A_g / c)^2 / (A_g / c), c the row's total, has
  mean G - 1 and variance
  [c^2 (2 (G - 1) + 6 H) + c (6 H - 2 G - 4 G^2) - 6 G^2] / ((c + 2) (c + 3)),
  H = sum_g 1 / A_g, both exact; summed over rows and standardised.
- `CategoricalFit`: tokens land in one cell of their group each (a word's
  topics, or the topics split by whether the token kept its previous one),
  independently given phi and theta. X = sum over cells of (O - E)^2 / V,
  E and V the exact mean and variance of each cell's count, has mean the
  number of cells; its variance is the Gaussian one, 2 sum rho^2 over each
  group's pairs of cells (rho their exact correlation), plus each cell's
  fourth cumulant over V^2. Cells with V under `MIN_VAR` are left out.
- `crt_z`: each topic's table count against its exact CRT mean and variance.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.precision import REFERENCE, Precision

DOCS = 4096  # documents in a block of the reference
MIN_VAR = 1.0  # a judged cell's count varies by at least a token's worth
A_MIN = 0.5  # the smallest Dirichlet group parameter judged


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fp16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).to(torch.float32)


SCORES_CONTROL = Precision("bfloat16", torch.float32, _bf16)
CRT_CONTROL = Precision("float16", torch.float32, _fp16)


def blocks(n: int, size: int = DOCS):
    for lo in range(0, n, size):
        yield lo, min(n, lo + size)


# ---------------------------------------------------------------------------
# count tables
# ---------------------------------------------------------------------------
def counts(z: torch.Tensor, words: torch.Tensor, mask: torch.Tensor, K: int, V: int):
    """(n_dk [D, K], n_kw [K, V], n_k [K]), int64, of topics z [D L] on the
    doc-major corpus words, mask [D, L]; masked tokens in no table."""
    D, L = words.shape
    dev = words.device
    n_dk = torch.zeros((D, K), dtype=torch.int64, device=dev)
    n_kw = torch.zeros(K * V, dtype=torch.int64, device=dev)
    zz = z.reshape(D, L).to(torch.int64)
    for lo, hi in blocks(D):
        valid = mask[lo:hi] > 0
        zb, wb = zz[lo:hi][valid], words[lo:hi][valid].to(torch.int64)
        rows = torch.arange(lo, hi, device=dev)[:, None].expand(hi - lo, L)[valid] - lo
        n_dk[lo:hi] = torch.bincount(rows * K + zb, minlength=(hi - lo) * K).reshape(hi - lo, K)
        n_kw += torch.bincount(zb * V + wb, minlength=K * V)
    n_kw = n_kw.reshape(K, V)
    return n_dk, n_kw, n_kw.sum(-1)


# ---------------------------------------------------------------------------
# the conditionals
# ---------------------------------------------------------------------------
def phi_params(n_kw: torch.Tensor, eta) -> torch.Tensor:
    """[K, V] phi | z ~ Dir(n_kw + eta), float64."""
    return n_kw.to(torch.float64) + float(eta)


def theta_params(n_dk: torch.Tensor, alpha, beta: torch.Tensor) -> torch.Tensor:
    """[D, K] theta_d | z, beta ~ Dir(n_dk + alpha beta_k), float64 (beta [K+1])."""
    K = n_dk.shape[-1]
    return n_dk.to(torch.float64) + float(alpha) * beta[:K].to(torch.float64)


def beta_params(m_k: torch.Tensor, gamma) -> torch.Tensor:
    """[K+1] beta | m ~ Dir(m_1 + 1e-8, ..., m_K + 1e-8, gamma), float64."""
    m = m_k.to(torch.float64) + 1e-8
    return torch.cat([m, torch.tensor([float(gamma)], dtype=torch.float64, device=m.device)])


def assign_probs(theta_rows: torch.Tensor, phi_cols: torch.Tensor) -> torch.Tensor:
    """[n, K] p(z_t = k) = theta_dk phi_kw / sum_j theta_dj phi_jw, in float64,
    of each token's theta row and phi column."""
    w = theta_rows.to(torch.float64) * phi_cols.to(torch.float64)
    return w / w.sum(-1, keepdim=True)


def assign_draw(theta_rows, phi_cols, generator: torch.Generator, p: Precision) -> torch.Tensor:
    """[n] topics drawn as argmax of log theta + log phi in precision p plus
    float64 Gumbel noise (the control's draw)."""
    score = p(p(torch.log(p(theta_rows))) + p(torch.log(p(phi_cols)))).to(torch.float64)
    u = torch.rand(score.shape, generator=generator, dtype=torch.float64, device=score.device)
    u = u.clamp(torch.finfo(torch.float64).tiny, 1.0 - torch.finfo(torch.float64).eps)
    return torch.argmax(score - torch.log(-torch.log(u)), dim=-1)


def dirichlet_draw(params: torch.Tensor, generator: torch.Generator, p: Precision) -> torch.Tensor:
    """Rows ~ Dir(params), a ratio of Gamma draws with the arithmetic in p."""
    g = p(torch._standard_gamma(params, generator=generator))
    return p(g / p(g.sum(-1, keepdim=True)))


def crt_moments(n_dk: torch.Tensor, conc: torch.Tensor, max_count: int):
    """(mean [K], var [K]) of m_k = sum_d CRT(n_dk, conc_k), exact: the sums
    over d of sum_{i < n_dk} p_i and p_i (1 - p_i), p_i = conc_k / (conc_k + i)."""
    a = conc.to(torch.float64)
    i = torch.arange(max_count, dtype=torch.float64, device=a.device)
    p = a[:, None] / (a[:, None] + i)  # [K, max_count]
    zero = torch.zeros_like(p[:, :1])
    mean_tab = torch.cat([zero, p.cumsum(-1)], -1)  # [K, max_count + 1]: the sum over i < n
    var_tab = torch.cat([zero, (p * (1.0 - p)).cumsum(-1)], -1)
    K = a.shape[0]
    mean = torch.zeros(K, dtype=torch.float64, device=a.device)
    var = torch.zeros_like(mean)
    for lo, hi in blocks(n_dk.shape[0], 1 << 16):
        n = n_dk[lo:hi].to(torch.int64).clamp(max=max_count).T  # [K, docs]
        mean += mean_tab.gather(1, n).sum(-1)
        var += var_tab.gather(1, n).sum(-1)
    return mean, var


def crt_draw(n_dk: torch.Tensor, conc: torch.Tensor, max_count: int, generator: torch.Generator,
             p: Precision) -> torch.Tensor:
    """[K] m_k = sum_d CRT(n_dk, conc_k) drawn with the probabilities in p."""
    a = conc.to(torch.float64)
    m = torch.zeros(a.shape[0], dtype=torch.float64, device=a.device)
    for lo, hi in blocks(n_dk.shape[0], 1 << 16):
        n = n_dk[lo:hi].to(torch.int64)
        for i in range(max_count):
            prob = p(a / (a + i)).to(torch.float64)
            u = torch.rand(n.shape, generator=generator, dtype=torch.float64, device=a.device)
            m += ((u < prob) & (n > i)).sum(0)
    return m


def crt_z(m_k: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> float:
    """max_k |m_k - mean_k| / sd_k; a topic whose count cannot vary must equal its mean."""
    m = m_k.to(torch.float64)
    fixed = var <= 0
    if bool((fixed & (m != mean)).any()):
        return math.inf
    z = (m - mean)[~fixed].abs() / var[~fixed].sqrt()
    return float(z.max()) if z.numel() else 0.0


def score_joint(n_dk: torch.Tensor, n_kw: torch.Tensor, alpha, beta: torch.Tensor, eta, p: Precision) -> float:
    """log p(z, w | beta, alpha, eta): the two Dirichlet-multinomial blocks,
    each term in p and summed in p's dtype."""
    K, V = n_kw.shape
    ab = float(alpha) * beta[:K].to(torch.float64)
    a0 = ab.sum()
    eta = torch.tensor(float(eta), dtype=torch.float64, device=ab.device)
    total = torch.zeros((), dtype=p.dtype, device=ab.device)
    for lo, hi in blocks(n_dk.shape[0], 1 << 16):
        n = n_dk[lo:hi].to(torch.float64)
        doc = torch.lgamma(a0) - torch.lgamma(a0 + n.sum(-1))
        total = total + p(doc).sum() + p(torch.lgamma(n + ab) - torch.lgamma(ab)).sum()
    nk = n_kw.to(torch.float64)
    word = torch.lgamma(V * eta) - torch.lgamma(V * eta + nk.sum(-1))
    total = total + p(word).sum() + p(torch.lgamma(nk + eta) - torch.lgamma(eta)).sum()
    return float(total)


# ---------------------------------------------------------------------------
# the statistics that judge a draw
# ---------------------------------------------------------------------------
def dirichlet_groups(params: torch.Tensor, occupied: torch.Tensor, chunk: int) -> torch.Tensor:
    """[R, N] each entry's group in its row: an occupied entry alone, the
    empty ones `chunk` at a time in index order (the last short run with the
    run before it), an empty group whose parameter is under A_MIN merged into
    the row's first occupied entry where it has one."""
    R, N = params.shape
    empty = ~occupied
    rank0 = empty.cumsum(-1) - empty.long()
    n0 = empty.sum(-1, keepdim=True)
    g0_count = (n0 // chunk).clamp(min=1)
    g0 = torch.minimum(rank0 // chunk, g0_count - 1)
    rank1 = occupied.cumsum(-1) - occupied.long()
    gid = torch.where(empty, g0, g0_count + rank1)
    sums = torch.zeros((R, N + 1), dtype=torch.float64, device=params.device).scatter_add_(1, gid, params)
    small = (sums.gather(1, gid) < A_MIN) & empty & (occupied.sum(-1, keepdim=True) > 0)
    return torch.where(small, g0_count.expand(R, N), gid)


class DirichletFit:
    """Sums of Q, its mean and its variance over Dirichlet rows (see the module)."""

    def __init__(self):
        self.q = self.mean = self.var = 0.0

    def add(self, x: torch.Tensor, params: torch.Tensor, occupied: torch.Tensor, chunk: int) -> None:
        R, N = params.shape
        gid = dirichlet_groups(params, occupied, chunk)
        zeros = torch.zeros((R, N + 1), dtype=torch.float64, device=params.device)
        A = zeros.scatter_add(1, gid, params)
        X = zeros.scatter_add(1, gid, x.to(torch.float64))
        c = params.sum(-1)
        has = A > 0
        G = has.sum(-1).to(torch.float64)
        m = torch.where(has, A / c[:, None], torch.ones_like(A))
        q = (c + 1.0) * torch.where(has, (X - m) ** 2 / m, torch.zeros_like(A)).sum(-1)
        H = torch.where(has, 1.0 / A.clamp(min=1e-300), torch.zeros_like(A)).sum(-1)
        var = (c * c * (2.0 * (G - 1.0) + 6.0 * H) + c * (6.0 * H - 2.0 * G - 4.0 * G * G) - 6.0 * G * G) \
            / ((c + 2.0) * (c + 3.0))
        rows = G >= 2
        self.q += float(q[rows].sum())
        self.mean += float((G - 1.0)[rows].sum())
        self.var += float(var[rows].sum())

    def t(self) -> float:
        return abs(self.q - self.mean) / math.sqrt(self.var) if self.var > 0 else math.inf


class CategoricalFit:
    """Observed and exact expected counts of tokens over the cells of W
    groups of M cells (each token lands in one cell of its group)."""

    def __init__(self, groups: int, cells: int, device):
        kw = dict(dtype=torch.float64, device=device)
        self.W, self.M = groups, cells
        self.obs = torch.zeros(groups * cells, **kw)
        self.e = torch.zeros(groups * cells, **kw)
        self.k4 = torch.zeros(groups * cells, **kw)
        self.g = torch.zeros((groups, cells * cells), **kw)

    def add(self, group: torch.Tensor, q: torch.Tensor, cell: torch.Tensor) -> None:
        """Tokens of `group` [n] with cell probabilities q [n, M] (float64),
        observed in `cell` [n]."""
        n, M = q.shape
        group = group.to(torch.int64)
        flat = (group[:, None] * M + torch.arange(M, device=q.device)).reshape(-1)
        self.obs.index_add_(0, group * M + cell.to(torch.int64), torch.ones(n, dtype=torch.float64, device=q.device))
        self.e.index_add_(0, flat, q.reshape(-1))
        pq = q * (1.0 - q)
        self.k4.index_add_(0, flat, (pq * (1.0 - 6.0 * pq)).reshape(-1))
        if self.W == 1:
            self.g[0] += (q.T @ q).reshape(-1)
        else:
            self.g.index_add_(0, group, (q[:, :, None] * q[:, None, :]).reshape(n, M * M))

    def t(self) -> float:
        W, M = self.W, self.M
        E = self.e.reshape(W, M)
        G = self.g.reshape(W, M, M)
        sigma = torch.diag_embed(E) - G
        var = torch.diagonal(sigma, dim1=-2, dim2=-1)
        keep = var >= MIN_VAR
        cells = int(keep.sum())
        if cells == 0:
            return math.inf
        dev = (self.obs.reshape(W, M) - E)[keep]
        x = float((dev ** 2 / var[keep]).sum())
        sd = torch.where(keep, var, torch.ones_like(var)).sqrt()
        rho = sigma / (sd[:, :, None] * sd[:, None, :])
        pair = keep[:, :, None] & keep[:, None, :]
        var_x = 2.0 * float((rho ** 2)[pair].sum()) + float((self.k4.reshape(W, M)[keep] / var[keep] ** 2).sum())
        return abs(x - cells) / math.sqrt(var_x)
