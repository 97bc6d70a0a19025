"""Posterior queries over collected assignment samples (port of `common_tpu/query.py`).

Rebuild of ``common:microscopes/common/query.py``: the co-assignment ("z")
matrix, a block-ordering heuristic for heatmaps, and group extraction.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def zmatrix(assignments) -> np.ndarray:
    """N x N co-assignment frequency matrix from S assignment samples.

    assignments: [S, N] int array or tensor (or a list of length-N vectors);
    a tensor is reduced on its own device. z[i, j] = fraction of samples in
    which i and j share a cluster. One [N, N] sum is kept and each sample
    added to it in turn, so no [S, N, N] array is built.
    """
    a = assignments if torch.is_tensor(assignments) else torch.from_numpy(np.asarray(assignments))
    if a.dim() != 2:
        raise ValueError(f"expected [S, N] assignments, got shape {tuple(a.shape)}")
    s, n = a.shape
    z = torch.zeros((n, n), dtype=torch.float32, device=a.device)
    for row in a:
        z += row[:, None] == row[None, :]
    return (z / s).cpu().numpy()


def zmatrix_reorder(z, order) -> np.ndarray:
    """Symmetrically permute a z-matrix by the given row/col order."""
    z = np.asarray(z)
    order = np.asarray(order)
    return z[np.ix_(order, order)]


def zmatrix_heuristic_block_ordering(z) -> np.ndarray:
    """Greedy similarity ordering so co-assigned blocks appear contiguous.

    Start from the row with the strongest total co-assignment, then
    repeatedly append the unvisited row most co-assigned with the current one.
    """
    z = np.asarray(z)
    n = z.shape[0]
    visited = np.zeros(n, dtype=bool)
    cur = int(np.argmax(z.sum(axis=1)))
    order = [cur]
    visited[cur] = True
    for _ in range(n - 1):
        sims = np.where(visited, -np.inf, z[cur])
        cur = int(np.argmax(sims))
        order.append(cur)
        visited[cur] = True
    return np.asarray(order)


def groups(assignment) -> List[np.ndarray]:
    """List of entity-index arrays, one per group (reference query.groups)."""
    a = assignment.cpu().numpy() if torch.is_tensor(assignment) else np.asarray(assignment)
    return [np.nonzero(a == gid)[0] for gid in np.unique(a) if gid >= 0]


def posterior_predictive_logp(scores: Sequence[float]) -> float:
    """Monte-Carlo predictive log-likelihood from per-sample logp values:
    log (1/S) sum exp(score_s), a logsumexp over posterior samples."""
    s = np.asarray(scores.cpu() if torch.is_tensor(scores) else scores, np.float64)
    m = s.max()
    return float(m + np.log(np.mean(np.exp(s - m))))
