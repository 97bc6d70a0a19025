"""Score-and-assign of the dense HDP-LDA sweep, in one launch a chunk of docs.

For every valid token t of doc d (word w) of a doc-major [D, L] corpus,

    z_t = argmax_k [ log theta_dk + log phi_kw + Gumbel_tk ],

the first k of the largest score, and the docs' topic counts n_dk of the new
z; a masked token (mask 0) keeps its old z and is counted nowhere.
`hdp_assign` launches `csrc/hdp_assign.cu` for CUDA tensors; the [docs, L, K]
score table never reaches device memory. It replaces no TPU kernel: the JAX
package runs the stage as plain `jnp` (`common_tpu/topic/hdp.py`
`blocked_sweep_dense`).

The noise is Philox4x32-10 keyed on (seed, 0x5EED): one call a token and
group of four topics g, counter (token, g, token >> 32, HDP_STREAM)
(`csrc/philox.cuh` hdp_words), its word j (x, y, z, w) the uniform of topic
4g + j (top 24 bits, floored at 1e-7) and the Gumbel draw -log(-log u).
`token` is the corpus's token index (doc0 + d) L + l, so the draws depend
on neither the chunking nor the launch geometry. `hdp_assign_plain` repeats the kernel's arithmetic in plain ops
with the same words: (log theta + log phi) + Gumbel in float32, the argmax's
first maximum; it is the CPU route.

Inputs
  words      [D, L] int64 word ids in [0, V)
  mask       [D, L] float32, 0 for a padding or held-out position
  z_old      [D, L] int32, the docs' current z
  log_theta  [D, K] float32
  log_phi_t  [V, K] float32 (a word's scores one row)
  seed       [1] int32, on the device of words
Returns (z [D, L] int32, dk [D, K] float32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from common_tpu_torch.ops import _build
from common_tpu_torch.ops.philox import HDP_STREAM, MASK32, gumbel_from_bits, philox4x32_10, philox_key

# The largest K the kernel takes: one doc's log theta row and integer
# counters in a block's 48 KB of shared memory (`hdp_assign_max_topics`).
MAX_TOPICS = 6143


def hdp_philox_gumbel(seed: torch.Tensor, tokens: torch.Tensor, k: int) -> torch.Tensor:
    """[len(tokens), k] float32: the Gumbel noise the CUDA kernel adds to the
    scores of corpus tokens `tokens` (int64 indices (doc0 + d) L + l), in plain
    ops. The last group of a K that is not a multiple of 4 uses only its first
    words."""
    groups = -(-k // 4)
    t = tokens.to(torch.int64)[:, None].expand(-1, groups)
    g = torch.arange(groups, device=tokens.device, dtype=torch.int64)[None, :].expand_as(t)
    words = philox4x32_10((t & MASK32, g, t >> 32, torch.full_like(t, HDP_STREAM)), philox_key(seed))
    bits = torch.stack(words, dim=-1).reshape(t.shape[0], 4 * groups)[:, :k]
    return gumbel_from_bits(bits)


def hdp_assign_plain(words, mask, z_old, log_theta, log_phi_t, seed: torch.Tensor,
                     doc0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the [D, L, K] score table plus the kernel's own noise,
    its argmax, and the doc counts by a scatter-add of ones (exact in float32
    up to 2^24 a slot)."""
    D, L = words.shape
    K = log_phi_t.shape[1]
    tokens = (doc0 + torch.arange(D, device=words.device))[:, None] * L + torch.arange(L, device=words.device)
    scores = log_theta[:, None, :] + log_phi_t[words]
    scores += hdp_philox_gumbel(seed, tokens.reshape(-1), K).view(D, L, K)
    valid = mask > 0
    z = torch.where(valid, torch.argmax(scores, dim=-1).to(torch.int32), z_old)
    zi = torch.where(valid, z.long(), K)  # column K: the masked tokens, dropped
    dk = torch.zeros((D, K + 1), dtype=torch.float32, device=words.device)
    dk.scatter_add_(1, zi, torch.ones((D, L), dtype=torch.float32, device=words.device))
    return z, dk[:, :K]


def _check(words, mask, z_old, log_theta, log_phi_t, seed) -> None:
    if words.dim() != 2 or log_theta.dim() != 2 or log_phi_t.dim() != 2:
        raise ValueError("expected words [D, L], log_theta [D, K], log_phi_t [V, K]")
    (D, L), K = words.shape, log_phi_t.shape[1]
    if mask.shape != (D, L) or z_old.shape != (D, L) or log_theta.shape != (D, K) or K < 1:
        raise ValueError(
            f"shape mismatch: words {tuple(words.shape)}, mask {tuple(mask.shape)}, z_old {tuple(z_old.shape)}, "
            f"log_theta {tuple(log_theta.shape)}, log_phi_t {tuple(log_phi_t.shape)}")
    if seed.numel() != 1:
        raise ValueError(f"seed must hold one value, got shape {tuple(seed.shape)}")
    for name, t in (("mask", mask), ("z_old", z_old), ("log_theta", log_theta), ("log_phi_t", log_phi_t),
                    ("seed", seed)):
        if t.device != words.device:
            raise ValueError(f"words is on {words.device} but {name} is on {t.device}")


def _check_cuda(words, mask, z_old, log_theta, log_phi_t, seed, out) -> None:
    want = (("words", words, torch.int64), ("mask", mask, torch.float32), ("z_old", z_old, torch.int32),
            ("log_theta", log_theta, torch.float32), ("log_phi_t", log_phi_t, torch.float32),
            ("z out", out[0], torch.int32), ("dk out", out[1], torch.float32))
    for name, t, dtype in want:
        if t.dtype != dtype or not t.is_contiguous() or t.device != words.device:
            raise ValueError(f"{name} must be contiguous {dtype} on {words.device}, got {t.dtype} on {t.device}")
    if seed.dtype != torch.int32:
        raise ValueError(f"seed must be int32, got {seed.dtype}")
    K = log_phi_t.shape[1]
    if K > MAX_TOPICS:
        raise ValueError(f"hdp_assign takes at most {MAX_TOPICS} topics, got {K}")
    if out[0].shape != words.shape or out[1].shape != log_theta.shape:
        raise ValueError(f"out shapes {tuple(out[0].shape)}, {tuple(out[1].shape)} do not match the docs")


def hdp_assign(words, mask, z_old, log_theta, log_phi_t, seed: torch.Tensor, doc0: int = 0,
               out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The docs' new z and their doc-topic counts (z [D, L] int32, dk [D, K]
    float32), written into `out` if given.

    `doc0` is the corpus index of the first doc, so a chunk of docs draws the
    noise a call over the whole corpus draws for it. CUDA: launches
    `csrc/hdp_assign.cu` (the dtypes of the module's docstring, contiguous).
    CPU: `hdp_assign_plain`. Any other device raises.
    """
    _check(words, mask, z_old, log_theta, log_phi_t, seed)
    device = words.device
    if device.type == "cpu":
        z, dk = hdp_assign_plain(words, mask, z_old, log_theta, log_phi_t, seed, doc0)
        if out is None:
            return z, dk
        out[0].copy_(z)
        out[1].copy_(dk)
        return out
    if device.type != "cuda":
        raise ValueError(f"hdp_assign: no kernel for device {device}")
    D, L = words.shape
    K, V = log_phi_t.shape[1], log_phi_t.shape[0]
    if out is None:
        out = (torch.empty((D, L), dtype=torch.int32, device=device),
               torch.empty((D, K), dtype=torch.float32, device=device))
    _check_cuda(words, mask, z_old, log_theta, log_phi_t, seed, out)
    if D == 0:
        return out
    index = device.index
    err = _build.library().hdp_assign_launch(
        words.data_ptr(), mask.data_ptr(), z_old.data_ptr(), log_theta.data_ptr(), log_phi_t.data_ptr(),
        seed.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), D, L, K, V, int(doc0), index,
        torch._C._cuda_getCurrentRawStream(index),
    )
    _build.check(err, "hdp_assign_launch")
    hdp_assign.launches += 1
    return out


hdp_assign.launches = 0
