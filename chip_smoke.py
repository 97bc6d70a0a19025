#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`common_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. Environment: the card's name and power limit (nvidia-smi), and the
   build of the CUDA kernels from `common_tpu_torch/csrc/` (one nvcc per
   source, all at once), with each kernel's registers and spills and
   ptxas's notes (`-Xptxas -v`), and the dynamic shared memory a block of
   the Gaussian assignment's warpgroup route asks for at D = 16, 64, 128
   and 256.
2. Each kernel against its plain PyTorch version on the card:
   assignment on well-separated clusters (n=16421, D=256, K=64, dense
   triangular B_k) against the plain sampler, and draw for draw against
   the plain scores plus the kernel's own Philox noise, there, on
   clusters told apart by B_k alone (these at D = 256 on the warpgroup
   route), and at the widest D the kernel takes (n=4113, D=384, K=16)
   and a D that fills no panel (n=5003, D=203, K=33), both on the
   `mma.sync` route; its sampling distribution (n=64, D=4, K=5, 300 seeds); the
   multi-chain assignment draw for draw on dense, non-triangular B_k
   (n=16421, D=256, K=64, C=4), equal to the single-chain kernel at C=1,
   and its distribution with independent chains (n=64, D=4, K=5, C=3, 300
   seeds); the linear assignment draw for draw at 100k x 64, K=32, at a
   ragged N with D=300, K=33, at D=61, K=70 (4-byte copies, three cluster
   panels, a group of four cut short) and at 1,000,003 x 64, K=32 (many
   tiles a block), and its distribution; scatter stats at 1M x 256,
   K=64 with masked rows and a ragged N (and exactly symmetric), and at a
   small shape against float64 on the host.
3. The main path at 1M x 256, K_max=64: model_definition -> initialize
   (CRP) -> runner(..., [("assign_blocked_fused", {})]); one first sweep,
   timed apart because it carries the one-time CUDA library set-up, then
   .run(gen, 10) with the kernels' launch counts set to 0 just before.
   4096 held-out rows. Checks finite scores, counts, kernel launch counts,
   the stats against the plain restat, k_active and the held-out log
   density; checks the assignment kernel draw for draw on the main path's
   own inputs, and the scatter kernel against float64 (computed on the
   card) on the largest cluster, with sum_xxT equal to its transpose bit
   for bit; times fused and plain sweeps, and each kernel against its plain
   version, its bound and its library yardstick on those inputs (the
   scatter wrapper's sort and search apart from its kernels); the
   assignment kernel on both routes in turns (warpgroup, mma.sync,
   mma.sync, warpgroup: `ms` and `mma_sync_ms`), the `mma.sync` route
   through the library's own entry point and checked draw for draw too,
   and all 10 launches of the run on the warpgroup route; the replay
   check (below) on 2 runner steps; traces one more sweep for device time
   by kernel and the device's idle share.
4. Path A, multi-chain, on the data of phase 3: four CRP initialisations,
   stacked; one first sweep_chains(..., fused=True) timed apart, then 5
   sweeps with the counts set to 0 just before, each followed by every
   chain's score_joint and held-out log density. Checks launches (the
   multi-chain kernel once a sweep, the scatter kernel once a chain a
   sweep), counts, finite values, the stats against the plain restat, and
   the multi-chain kernel draw for draw on the sweep's own inputs over all
   rows and chains (and on the `mma.sync` route), every launch on the
   warpgroup route, and the replay of one sweep_chains; prints
   split-R-hat, ESS, chain-sweeps/s, the kernel on both routes in turns
   against its plain version and the idle share of a traced sweep.
5. Path B, config 2: a Beta-Bernoulli DPMM at 100k x 64, K_max=32 (8
   planted Beta(0.5, 0.5) profiles, numpy seed 0, 4096 held-out rows),
   runner(..., [("assign_blocked_fused", {}), ("slice_hp", {...})]) for 8
   iterations with the counts set to 0 just before. Checks launches
   (the linear kernel once an iteration, the slice update 129 times),
   finite scores, counts, the held-out log density against the
   one-cluster state's, the linear kernel draw for draw on the path's
   own inputs and on the CRP start's, each of the 129 slice updates of
   one more `slice_.hp` on the final state against its plain version bit
   for bit, and the replay of 2 runner iterations with their resume pair;
   prints iterations/s, the linear kernel against its plain version, its
   library yardstick warm and L2-cold, the noise its inputs need, the
   slice update kernel's time an update, and the slice sampler's share.
6. BASELINE config 1 by collapsed Gibbs: 10,000 x 2 rows around the three
   planted centers of `examples/dpmm.py` (scale 0.6, numpy seed 0),
   `models.niw(2)`, K_max=32, alpha=1, CRP initial state;
   runner(..., [("assign", {}), ("grid_cluster_hp", {...})], jsonl_path=...)
   for 13 sweeps. Checks the co-assignment agreement of `query.zmatrix`
   over the last 4 sweeps with the planted labels (bar > 0.95), finite
   scores, one JSONL line per sweep, that none of the four kernels ran;
   checkpoints after 1 sweep with the generator, resumes for 1 more and
   requires the assignments and scores of the uninterrupted run's first 2
   sweeps bit for bit; runs one sweep under
   `torch.cuda.set_sync_debug_mode("error")`; prints rows/s, and the
   kernel launches per row and idle share of a traced sweep over the first
   300 rows. Then subsample annealing over the same rows from an empty
   state, `linear_schedule(10000, add_per_step=64, resample_per_step=64)`:
   checks every row active, counts and stats against a restat, no kernel
   launched; prints updates/s and the agreement with the planted labels (no
   bar: one state).
7. BASELINE config 5 by block-SMC on phase 3's rows (run before phase 5 frees
   them): `smc.run_blocked` with P=16, block=8192, warmup=128,
   rejuvenation_blocks=1, K_max=64, alpha=1, phase 3's hypers, the kernel
   counts set to 0 just before. Checks every particle seats all N rows
   with counts a bincount of its z, the top-weight particle's stats within
   1e-4 of a plain restat, kernel 2's launches equal to 3 a block and no
   other kernel, logz finite and at least phase 3's best joint score minus
   1e-4 of its size, at most half the steps with ESS < 2; prints rows/s,
   the resamples, the ESS, the weighted cloud's held-out density beside the
   JAX record (history, other data), kernel 2 on one block's own inputs
   against its plain version, and the idle share of one traced block step;
   then the replay of `run_blocked` at these settings on the first 65,536
   rows (cut from 1M for time).
8. Split-merge at 1M x 256 on phase 3's final state: the runner's
   [assign_blocked_fused, split_merge(n_moves=4, t_scans=3)] once, then 4
   moves timed one by one. Checks kernel launches (one sweep, 5 a merge
   proposal and 6 a split), counts, stats against a plain restat, exact
   zeros in empty slots; prints ms a move and what each proposed and
   whether it was accepted.
9. BASELINE config 3 (run before phase 6): 100,000 rows + 2,048 held out
   of 8 planted clusters over niw(16) + gp + bb columns (numpy seed 0,
   `config3_rows`), K_max=32, alpha=1, the recipe's hypers and Exp(1)
   priors (bench.py:903-1007); runner(..., [("assign_blocked", {}),
   ("nuts_hp", {...}), ("nuts_cluster_hp", {...})], 2 transitions of depth
   at most 5 each) once, then 10 iterations with the counts set to 0 just
   before. Checks no kernel launched, finite scores, hypers in their
   support, counts a bincount of z, stats against a plain restat, the
   held-out logp/row above the one-cluster state's, the replay of 2 runner
   iterations with their resume pair, and the NUTS hyper target's
   gradient (fp32, card) within 1e-3 of float64 on the CPU; prints
   iterations/s, each runner kernel's ms and share, the NUTS transitions'
   leaves, depth, acceptance, divergences and host reads,
   the idle share of a traced iteration, a transition against 31 leaves
   issued with no read, and the cost of one read. Then SVI on the same
   rows: `svi.init`, 30 CAVI steps (the ELBO never falls by more than 1e-5
   of itself; the first 3 steps against float64 on the CPU from the same
   posterior, and replayed), 200 minibatch steps at batch 1024 (the ELBO above init's),
   `to_state` and `predictive_logpdf` held-out densities; and nuts_theta
   on a bbnc state over the binary column (p inside its bounds and within
   6 sd of its Beta conditional).
10. BASELINE config 4, HDP-LDA (run after phase 9, before phase 6), at the
   JAX record's recipe, not cut (bench.py:1010-1110): 1,000,000 docs of 50
   tokens, V = 10,000 in 4 planted blocks of 2,500 words (doc d draws from
   block d % 4), 1% of positions held out, K = 32, made on the card.
   (a) blocked_sweep_dense(doc_chunk=20,000) + sample_beta(max_count=50) +
   score_joint: 18 sweeps, untimed (the benchmark's cell
   hdp_lda_1m_docs.dense times them through the runner). Before and after
   them, `ops.hdp_assign` on one chunk of 20,000 docs: one launch under
   `set_sync_debug_mode("error")`, z and the doc counts equal to the plain
   version's bit for bit; prints the
   kernel's ms a chunk, the plain version's, the old ATen route's and the
   whole stage's a sweep. Checks the count tables
   equal a recount of z, each doc_topic row sums to its doc's tokens, beta
   on the simplex, held-out z unmoved, the score above the initial state's,
   the held-out perplexity under 5,000, hdp_assign launched 50 times a
   sweep and no other kernel, the replay of
   2 dense sweeps + sample_beta, and one runner step of
   [assign_blocked_dense(doc_chunk=20,000), beta] under
   `set_sync_debug_mode("error")` equal to blocked_sweep_dense +
   sample_beta bit for bit; prints peak memory, the float64 gap of
   score_joint, the largest count slot and the held-out perplexity, beside
   the JAX record's 2887.67 and the planted
   floor of 2,500 (history, no bar). (b) The runner's HDP family,
   [assign_blocked, concentrations], 2 iterations on the flat corpus and one
   step under `set_sync_debug_mode("error")`: finite alpha and gamma,
   recounts; prints ms an iteration by kernel and the flat sweep's peak
   memory. (c) examples/lda_topics.py's corpus (200 x 30, V = 30, K = 10)
   through [assign, concentrations] with a JSONL trace: 5 sweeps, a
   checkpoint after 1 sweep resumed for 1 more equal bit for bit; prints
   ms a sweep, the perplexity drop and launches a token. (d) Online LDA on
   the first 100,000 training docs ([100,000 x 10,000] f32 counts: docs
   cut, not width): 10 CAVI steps (the bound never falls by more than 1e-5
   of itself), the first step on 2,000 docs within rtol 1e-4 of float64 on
   the CPU, 200 SVI steps at batch 1024 lowering the held-out perplexity of
   docs 100,000-101,999 below init's.
11. The IRM (run after phase 10, before phase 6), at the JAX record's width
   (BENCH_NOTES.md:448-453): (a) a fully observed 4096 x 4096 Beta-Bernoulli
   relation (16,777,216 cells) in 8 x 8 planted blocks of 512 (0.85 on the
   diagonal, 0.1 off it, three off-diagonal blocks at 0.6; numpy seed 0),
   K_max=32 in both domains, alpha=1; the runner's [assign_blocked] for 30
   sweeps from each of 6 starts uniform over the 32 slots. Checks finite
   scores, no kernel launched, the best-scoring chain's co-assignment
   agreement with the planted labels above 0.95 in both domains, counts
   summing to N_d, the n stats to the 16.8M cells, counts and stats equal to
   a rebuild, one runner step under `set_sync_debug_mode("error")`, each
   domain's [4096, 32] table built twice from one state and theta equal bit
   for bit (0 entries differ; the table is an order-fixed segment sum, no
   atomics), and the replay of 3 blocked sweeps and of the runner's
   resume pair; prints
   each chain's sweeps/s and agreement, cells/s, peak memory, the ms of a
   sweep's theta draw, each domain's table and argmax and the restat, the
   idle share of a traced sweep, and the same 30 sweeps from a CRP start
   (no bar). (b) A blocked sweep on a 512 x 512 self-relation with 8 planted
   blocks (the sequential-given-theta path), 10 sweeps: ms a sweep, the
   agreement, the bookkeeping; and examples/irm_links.py's recipe (30 x 30,
   15% held out) through [assign, ew_domain_alpha] x 25 from 6 CRP starts:
   the best-scoring chain's held-out link accuracy at least 0.95 (the JAX
   example's CPU run: 1.000), one collapsed sweep under the sync check, its
   launches an entity and idle share. (c) A checkpoint of the collapsed
   runner's state after 1 iteration, resumed for 1 more, equal bit for bit
   to 2 straight. (d) A 1024 x 1024 nich relation (float suffstats, which
   bb's integer counts hide; 8 x 8 planted block means, 10% of cells
   missing, numpy seed 0): the replay of 3 blocked sweeps, and of one
   collapsed sweep over the 30 entities of its first 30 rows (a 30 x 1024
   cut); prints the ms of each.
12. The multi-device layer and the CSV loader (run after phase 11, before
   phase 6), on the main path's 1M x 256 rows (`headline_data()` anew),
   K_max=64. (a) World size 1 over NCCL: 3 sweeps of
   `parallel.make_sharded_sweep` equal 3 `sweep_fused` sweeps from the same
   state and generator bit for bit, with 3 launches each of kernels 1 and 2
   and no other; kernel 1 over rows [0, N/2) and [N/2, N) with row_offset
   N/2 equals one launch over all rows outside the fp32 tie band; the
   sharded and the one-device sweep timed in turns beside phase 3's rate,
   and the all_reduce alone. (d, world size 1) `smc.run_blocked_sharded`
   equals `smc.run_blocked` bit for bit (logz, log-weights, assignments,
   resamples) at phase 7's settings on the first N12 = 262,144 rows (cut
   from 1M for time), kernel 2 three times a block and no other kernel;
   the best joint score of 8 blocked sweeps on those rows bounds logz. (b)
   Two processes sharing the card over gloo (spawned; a plumbing rate, not
   a multi-card one), on a (1 x 2) and a (2 x 1) mesh, 500,000 rows a rank:
   each rank's kernel-1 draw with its row_offset against its plain scores
   plus the noise of its global rows; after 1 + SWEEPS12 sweeps the
   all-reduced counts and stats and the next sweep's theta bit-identical
   across the data ranks; the gathered chain's counts and stats within 1e-4 of a plain
   restat, sweeps/s and the all_reduce alone; then block-SMC with its 16
   particles over the two ranks: the same logz on both, at least the
   joint bound minus 1e-4 of it, every row seated, the top particle's
   bookkeeping, rows/s, resamples, one resample's particle all_gather.
   (c) With 2 or more cards, (b)'s sweeps over NCCL on min(count, 4) cards;
   otherwise a line says one card was found. (e) `measure_row_scaling`
   at shard counts (1, 2), both ranks on the one card over gloo: a
   plumbing check. (f) `io.load_csv_f32` on a 200,000 x 64 CSV: the
   native parse equals numpy's; rows/s and MB/s of both on the card
   machine's host. A failure in any child process fails the run.
13. The sharded HDP and IRM sweeps (run after phase 12, before phase 6).
   (a) World size 1 over NCCL, at full width, each pair in turns (sharded,
   one-device, one-device, sharded), SWEEPS13 sweeps a turn from one start
   and generator seed: `topic.make_sharded_sweep_dense` + `sample_beta`
   with the mesh against `blocked_sweep_dense` + `sample_beta` on phase
   10's corpus (1M docs x 50 tokens, V = 10,000, K = 32, doc_chunk
   CHUNK10); `topic.make_sharded_sweep` against `blocked_sweep` on the same
   corpus flattened (50M tokens, CHUNK13 tokens a table); the IRM's
   `make_sharded_sweep` against `relational.sweep` on phase 11's 4096 x
   4096 relation, K_max 32, in torch's default mode (the table and the
   suffstats are order-fixed segment sums). Each pair equal bit for bit (z, count
   tables, beta; assignments, counts, suffstats), no kernel launched but
   the dense sweeps' hdp_assign, 50 a sweep;
   prints ms a sweep of both sides, the all_reduce's ms and MB, the peak
   memory. (b)
   Two processes sharing the card over gloo (a plumbing rate, not a
   multi-card one), BSWEEPS13 sweeps of each: the token-sharded sweep with
   a beta move and the doc-sharded sweep with the mesh's beta and
   concentration moves on the first D13B docs of the corpus (docs cut, full
   L, K, V), the cell-sharded IRM sweep on the full relation. Checks the
   gathered z and a recount equal the all-reduced tables (the IRM's counts
   and suffstats a rebuild), the replicated leaves bit-identical on both
   ranks, no kernel launched but the dense sweeps' hdp_assign (a launch a
   chunk of the rank's docs); prints sweeps/s and the all_reduce's ms. (c) With 2 or more
   cards, (b) over NCCL on min(count, 4) cards; otherwise a line says one
   card was found.

14. The port bench's smoke tiers (run after phase 13, before phase 6):
   `common_tpu_torch.bench.main(["--smoke"])` in-process, the kernel counts
   set to 0 just before: 20,000 x 16, K_max=16, 10 sweeps by the plain
   sweep, then by the fused one. Checks exit 0, bench.py's keys on the last
   line (`mfu` and `peak_tflops` in place of `mfu_vs_bf16_peak`, the
   headline last, `device` the card's line), mfu in [0, 1), and kernels 1
   and 2 launched once a sweep of the fused tier's warm-up and timed runs,
   no other kernel.
15. Every Beta parameter inside (0, 1) on the card (run after phase 14,
   before phase 6): `sample_params` of bb, bnb, bbv and bbnc on CUDA
   tensors, 10,000 slots of 10^6 heads (bnb: zero counts) at hyper beta
   0.5, where a plain `rng.beta` from the same generator state puts about
   1 draw in 5 at exactly 1.0: no draw at 0 or 1 (those at the largest
   float below 1) and a finite score table; then 10 blocked sweeps of a
   DP mixture of a nich column (two clusters at -5 and 5, 500,000 rows
   each) and an all-heads bb column, from the planted assignment: finite
   scores and k_active above 1 after every sweep. No kernel runs.

Replay checks (phases 3, 4, 5, 7, 9, 10 and 11): a path run twice from one
start state and one generator seed must end equal bit for bit in every
leaf (assignments, counts, every stats leaf, the hypers, and a runner's
score trace); where the path has a runner, 1 step, a checkpoint with the
generator and 1 more step from the restored state must also end equal to 2
straight steps.

In the `kernels` line, `max_abs_err` of scatter_stats is max|kernel - plain|
on the main path's z. The assignment kernels return labels, so their
`max_abs_err` is the largest shortfall, in nats, of the perturbed score of
the kernel's choice below the plain maximum (0 where they agree, at most
the fp32 tie band on a tie), with `mismatch` the rows outside the tie band
that differ and `tie_rows` the rows inside it, on their path's own inputs.
Each `launches` is the count from its path's driven run (phases 3, 4, 5,
and 7 for the second scatter entry, kernel 2 on block-SMC's inputs: one
block's P * B rows with the P particles' slots side by side, P * K
clusters).
`bound_ms` is the least time the H100 could take for the kernel's work on
this run's inputs: the larger of its operations, as three TF32 passes on
the tensor cores (fp32 accuracy by 3xTF32 split products, 495 TFLOP/s),
and its bytes (each input read once, each output written once, 3.35
TB/s); `bound_fp32_ms` gives the fp32 CUDA-core figure (67 TFLOP/s)
beside it. `library_ms` times one PyTorch call doing the same products in
fp32 (named under `library`), which the port never calls: for the
Gaussian assignment, X times the stacked B_k^T over row slices; for the
scatter, torch.mm(X.T, X); for the linear assignment, torch.addmm. The
scatter entry's `ms` is its two kernels with their chunk schedule,
`sort_ms` the sort and search before them, `wrapper_ms` the whole call.
The linear assignment runs for tens of microseconds, about as long as the
host takes to issue a call. Its `ms`, `plain_ms` and `library_ms` are
timed as every other kernel's, 20 calls back to back (`cuda_ms`), so the
host's issue counts where it is slower than the card, as it does in the
sweep; `device_ms` and `library_device_ms` time the same calls queued
behind a spin kernel (`queued_ms`: the card's time alone); `ms_cold` and
`library_ms_cold` time each launch alone after a 64 MB write that evicts X
from the 50 MB L2 (`cold_ms`), as the sweep finds it. Phase 5's record
(not the `kernels` line) gives the noise the kernel's inputs need, worked
out in Python from the scores (`noise_work`), and the kernel's times at
the CRP start, where the clusters lie close together.

A `sharded_launches` line before the `kernels` line gives phase 12's
launches of kernels 1 and 2 on the sharded sweep and sharded block-SMC.

The line before the last is the card's name and power limit; the last is
{"ok": true, "device": {...}}. Needs a CUDA card: without one it exits 1.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

SEED = 0
N, D, K_MAX, HELDOUT = 1_000_000, 256, 64, 4096
N_SWEEPS = 10
N_CHAINS, CHAIN_SWEEPS = 4, 5
N2, D2, K2, ITERS2 = 100_000, 64, 32, 8  # config 2
N6, K6, SWEEPS6, LAST6, TRACE_ROWS6 = 10_000, 32, 13, 4, 300  # config 1, collapsed
ADD6, RESAMPLE6 = 64, 64  # phase 6's subsample annealing schedule
# config 5 by block-SMC, at the JAX record's settings (BENCH_MEASURED_R5.json:91-118)
P7, BLOCK7, WARMUP7, REJUV7 = 16, 8192, 128, 1
REPLAY7 = 65_536  # rows of config 5's replay check (cut from 1M for time)
SLACK7 = 1e-4  # logz may sit this share of |bound| below phase 3's best joint (fp32 sums over 123 blocks)
MOVES8, SCANS8 = 4, 3  # phase 8's split-merge moves at 1M x 256
# config 3 (bench.py:903-1007): niw(16) + gp + bb at 100k rows (+ 2048 held out), K_max=32
N9, DG9, K9, HELD9, ITERS9 = 100_000, 16, 32, 2048, 10
STEPS9, DEPTH9 = 2, 5  # the recipe's NUTS transitions a kernel call and tree depth
CAVI9, CHECK9, SVI9, BATCH9 = 30, 3, 200, 1024  # CAVI steps (the first CHECK9 against f64), SVI steps, batch
THETA9 = 3  # nuts_theta iterations on a bbnc state over phase 9's binary column
# config 4, HDP-LDA, at the JAX record's recipe (bench.py:1010-1110, run_hdp_tier(1_000_000,
# 50, 32, 10_000, 3, ...) at bench.py:1550), not cut: D docs of L tokens over V words in
# BLOCKS planted blocks, K topics, HELD10 of token positions held out, doc_chunk CHUNK10
D10, L10, K10, V10, BLOCKS10, HELD10, CHUNK10 = 1_000_000, 50, 32, 10_000, 4, 0.01, 20_000
SWEEPS10, RUNNER10 = 18, 2  # the chain's sweeps, runner iterations
JAX_PPL10 = 2887.67  # BENCH_r05.json summary.hdp: a TPU run with threefry draws; history, never a bar
# (c) examples/lda_topics.py's corpus through the collapsed runner; (d) online LDA on the
# first LDA10 training docs of (a)'s corpus (docs cut, not width), docs LDA10.. + HELD_LDA10 held out
DOCS10C, LEN10C, V10C, K10C, MORE10C, TRACE_DOCS10C = 200, 30, 30, 10, 3, 20
LDA10, HELD_LDA10, CAVI10, CHECK_DOCS10, SVI10, BATCH10 = 100_000, 2_000, 10, 2_000, 200, 1024
# phase 11, the IRM at the JAX record's width (BENCH_NOTES.md:448-453): a fully observed bipartite
# N11 x N11 Beta-Bernoulli relation in BLOCKS11 x BLOCKS11 planted blocks, K_max K11 in both domains,
# SWEEPS11 blocked sweeps of the runner from each of FULL_CHAINS11 starts uniform over the K11 slots;
# the best-scoring chain must recover the blocks. Blocked Gibbs cannot split a cluster that holds two
# planted blocks, and one chain in three keeps such a merge (see PERF.md); from a CRP start most do,
# in both packages: one such chain runs too, with no bar
N11, BLOCKS11, K11, SWEEPS11, FULL_CHAINS11 = 4096, 8, 32, 30, 6
SELF11, SELF_SWEEPS11 = 512, 10  # (b) a blocked self-relation: the sequential-given-theta path at size
NICH11 = 1024  # (d) a nich relation for the replay check of the float-leaf restat and collapsed step
# (b) examples/irm_links.py's recipe through [assign, ew_domain_alpha] from LINK_CHAINS11 CRP starts: the
# best-scoring chain must predict the held-out links to LINK_BAR11 (the JAX example's CPU run: 1.000 of
# 147 cells; from one start collapsed Gibbs may stay in one or two clusters, in both packages)
LINK_N11, LINK_ITERS11, LINK_CHAINS11, LINK_BAR11 = 30, 25, 6, 0.95
# generator seeds of phase 6's CRP initial state and of its sweeps (see PERF.md:
# collapsed Gibbs moves one row at a time, and from some starts keeps a planted
# cluster split in two for tens of sweeps; from this one it recovers all three)
INIT6, GEN6 = 5, 105
# phase 12: sharded sweeps timed a turn; block-SMC at phase 7's settings on the first N12 of the
# main path's rows (cut from 1M for time); blocked sweeps whose best joint bounds its logz; the CSV
SWEEPS12, N12, JOINT_SWEEPS12 = 3, 262_144, 8
CSV_ROWS12, CSV_COLS12 = 200_000, 64
SPAWN_TIMEOUT12 = 300  # seconds before the ranks of (b) or (c) are killed and the run fails
# phase 13: the sharded HDP (phase 10's corpus) and IRM (phase 11's relation) sweeps. (a) world size 1
# over NCCL at full width, SWEEPS13 sweeps a turn, the flat sweep CHUNK13 tokens a table; (b) two gloo
# ranks on the card, BSWEEPS13 sweeps each, the HDP corpus cut to D13B docs (full L, K, V)
SWEEPS13, CHUNK13, BSWEEPS13, D13B = 3, 1 << 22, 4, 250_000


# NVIDIA H100 SXM published peaks (data sheet, dense): TF32 on the tensor
# cores, fp32 on the CUDA cores, HBM3 bandwidth. A kernel's bound_ms counts
# its fp32-accurate products as three TF32 passes (3xTF32 split products).
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
LIB_ROWS = 65536  # row slice of the library products that stand in for kernels 1 and 4


class SmokeFailure(Exception):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` on the current stream, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SPIN_CYCLES = 20_000_000  # about 10 ms of the H100's clock
FLUSH_BYTES = 64 << 20     # more than the 50 MB L2


def queued_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` launched back to back, after one warm-up,
    queued behind a spin kernel of about 10 ms: the host issues every launch
    before the first runs, so the events time the card, not the issue."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int) -> float:
    """Median milliseconds of one `fn()` with its inputs out of L2: each
    launch timed by its own events after a 64 MB write and a spin of about
    0.5 ms, during which the host issues it."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    pairs = []
    for i in range(reps):
        flush.fill_(float(i))
        torch.cuda._sleep(SPIN_CYCLES // 20)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(flops: float, nbytes: float) -> dict:
    """The least time of `flops` fp32-accurate operations and `nbytes` moved
    (each input read once, each output written once): bound_ms, its
    resource, and the fp32 CUDA-core figure beside it."""
    op_ms = 1e3 * 3 * flops / PEAK_TF32
    byte_ms = 1e3 * nbytes / PEAK_BYTES
    return {"bound_ms": max(op_ms, byte_ms), "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "bound_fp32_ms": max(1e3 * flops / PEAK_FP32, byte_ms)}


def gaussian_yardsticks(x, mu, binv, n_chains: int = 1) -> dict:
    """Kernel 1 or 4's bound and its library yardstick: fp32 torch.matmul of
    X [rows, D] by the stacked B_k^T [D, slots * D], over LIB_ROWS-row slices
    (a quarter of that with C > 1), summed; the product alone."""
    import torch

    (n, d), slots = x.shape, mu.shape[0]
    flops = 2.0 * n * slots * d * d
    nbytes = 4.0 * (n * d + slots * d + slots * d * d + slots + n_chains * n)
    bt = binv.transpose(1, 2).permute(1, 0, 2).reshape(d, slots * d)
    rows = LIB_ROWS // n_chains
    out = torch.empty((rows, slots * d), device=x.device)

    def product():
        for a in range(0, n, rows):
            b = min(n, a + rows)
            torch.matmul(x[a:b], bt, out=out[:b - a])

    lib = cuda_ms(product, 2)
    del out
    return {**bound(flops, nbytes), "library_ms": lib,
            "library": f"torch.matmul(X[{rows} rows], [{d}, {slots * d}]) over {n} rows, fp32"}


def mma_sync_route(x, mu, binv, base, seed, n_chains: int = 0):
    """Kernel 1 (n_chains 0) or 4 through the library's `mma.sync` entry
    point, whatever D: the route the warpgroup kernel replaced, timed
    beside it as a yardstick. The wrappers never call it at D = 256."""
    import torch

    from common_tpu_torch.ops import _build

    lib = _build.library()
    n, d = x.shape
    z = torch.empty((max(n_chains, 1), n), device=x.device, dtype=torch.int32)
    ptrs = (x.data_ptr(), mu.data_ptr(), binv.data_ptr(), base.data_ptr(), seed.data_ptr(), z.data_ptr())

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if n_chains:
            err = lib.gaussian_assign_chains_launch(*ptrs, n, d, mu.shape[0] // n_chains, n_chains, stream)
        else:
            err = lib.gaussian_assign_launch(*ptrs, n, d, mu.shape[0], 0, stream)
        _build.check(err, "mma.sync route")
        return z if n_chains else z[0]

    return run


def route_turns(wgmma_fn, mma_fn, reps: int) -> tuple:
    """Mean ms of each route, timed in turns (warpgroup, mma.sync, mma.sync,
    warpgroup): the medians of each route's two means, and every mean."""
    times = {"wgmma": [], "mma": []}
    for route in ("wgmma", "mma", "mma", "wgmma"):
        times[route].append(cuda_ms(wgmma_fn if route == "wgmma" else mma_fn, reps))
    return float(np.median(times["wgmma"])), float(np.median(times["mma"])), times


def profile_sweep(fn):
    """Device time by kernel, the idle share and the count of device kernels
    and copies, over one traced call of fn(); returns (idle share, count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    idle = 1 - busy / wall_ms
    launched = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    log(f"traced call: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share {idle:.3f}, "
        f"{launched} device kernels and copies")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {ms:9.3f} ms  {name[:90]}")
    return idle, launched


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def phase_environment() -> dict:
    import torch

    from common_tpu_torch.ops import _build

    # the plain versions and the library yardsticks run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    line = card_line()
    log(f"card: {line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    for path in sorted(_build.BUILD_DIR.glob("*.log")):
        for ln in path.read_text().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln or "(C75" in ln:
                log(f"  ptxas: {ln.strip()}")
    lib = _build.library()
    log("  kernels 1 and 4, warpgroup route: dynamic shared memory a block "
        + ", ".join(f"D={d}: {lib.gaussian_assign_wgmma_smem(d)} B" for d in (16, 64, 128, 256))
        + f" (of {torch.cuda.get_device_properties(0).shared_memory_per_block_optin} B); widest D "
        f"{lib.gaussian_assign_wgmma_max_dim()} (mma.sync route to {lib.gaussian_assign_max_dim()})")
    return {"card": line}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def _dense_binv(r, k, d, diag_lo, diag_hi):
    """[k, d, d] random lower-triangular B_k: dense below the diagonal."""
    off = np.tril(r.normal(scale=d ** -0.5, size=(k, d, d)), -1)
    return (off + np.eye(d) * r.uniform(diag_lo, diag_hi, size=(k, 1, d))).astype(np.float32)


def _assign_problem(n, d, k, sep, seed, device):
    """Rows around k centers `sep` apart, a dense triangular B_k per cluster."""
    import torch

    r = np.random.default_rng(seed)
    mu = r.normal(scale=sep, size=(k, d)).astype(np.float32)
    X = (mu[r.integers(0, k, n)] + r.normal(scale=0.5, size=(n, d))).astype(np.float32)
    binv = _dense_binv(r, k, d, 1.5, 2.5)
    base = np.zeros(k, np.float32)
    return [torch.from_numpy(a).to(device) for a in (X, mu, binv, base)]


def _covariance_problem(n, d, k, seed, device):
    """Clusters that differ mostly in B_k: every row's draw hangs on all of B_k."""
    import torch

    r = np.random.default_rng(seed)
    mu = r.normal(scale=0.3, size=(k, d)).astype(np.float32)
    X = r.normal(size=(n, d)).astype(np.float32)
    binv = _dense_binv(r, k, d, 0.5, 1.5)
    base = r.normal(size=k).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (X, mu, binv, base)]


def _seed(value: int, device):
    import torch

    return torch.tensor([value], dtype=torch.int32, device=device)


def exact_check(z, n, perturbed, rtol=3e-5, chunk=1 << 17, keep_tie=False) -> dict:
    """A kernel's z against the argmax of `perturbed(a, b)`, the plain scores
    plus the kernel's own Philox noise for rows a .. b-1, row for row.

    A row whose top two perturbed scores lie within rtol * |top| + 1e-3 of
    each other is an fp32 tie and may go either way; every other row must
    agree. `shortfall` is max_n (max_k v_nk - v_n,z_n) in nats: how far the
    perturbed score of the kernel's choice lies below the plain maximum.
    keep_tie adds "tie_mask", the [n] bool tensor of the tie rows.
    """
    import torch

    ties = mismatch = 0
    shortfall = 0.0
    masks = []
    for a in range(0, n, chunk):
        v = perturbed(a, min(n, a + chunk))
        top2, arg = v.topk(2, dim=-1)
        tie = (top2[:, 0] - top2[:, 1]) <= rtol * top2[:, 0].abs() + 1e-3
        zc = z[a:a + chunk].long()
        ties += int(tie.sum())
        mismatch += int(((zc != arg[:, 0]) & ~tie).sum())
        off = top2[:, 0] - v.gather(1, zc[:, None])[:, 0]
        shortfall = max(shortfall, float(off.max()))
        if keep_tie:
            masks.append(tie)
    torch.cuda.synchronize()
    out = {"rows": int(n), "ties": ties, "mismatch": mismatch, "shortfall": shortfall}
    return {**out, "tie_mask": torch.cat(masks)} if keep_tie else out


def assign_exact_check(z, X, mu, binv, base, seed, chain=0, row0=0, keep_tie=False) -> dict:
    """The Gaussian kernel (`philox_scores`), or chain `chain` of the
    multi-chain one given that chain's slots; X's first row drawn as global
    row row0 (a shard launched with that row_offset)."""
    from common_tpu_torch.ops.gaussian_assign import philox_scores

    return exact_check(z, X.shape[0], lambda a, b: philox_scores(
        X[a:b], mu, binv, base, seed, row0=row0 + a, chain=chain), keep_tie=keep_tie)


def chains_exact_check(z, X, mu, binv, base, seed, n_chains) -> dict:
    """The multi-chain kernel's z [C, N], every chain against its own slots."""
    K = mu.shape[0] // n_chains
    parts = [assign_exact_check(z[c], X, mu[c * K:(c + 1) * K], binv[c * K:(c + 1) * K],
                                base[c * K:(c + 1) * K], seed, chain=c) for c in range(n_chains)]
    return {"rows": sum(p["rows"] for p in parts), "ties": sum(p["ties"] for p in parts),
            "mismatch": sum(p["mismatch"] for p in parts),
            "shortfall": max(p["shortfall"] for p in parts)}


def linear_exact_check(z, X, W, base, seed) -> dict:
    from common_tpu_torch.ops.linear_assign import linear_philox_scores

    return exact_check(z, X.shape[0], lambda a, b: linear_philox_scores(
        X[a:b], W, base, seed, row0=a))


def require_exact(check: dict, what: str) -> dict:
    log(f"{what}: {check['mismatch']} of {check['rows']} rows differ from the plain "
        f"argmax with the kernel's noise outside the fp32 tie band (bar 0); "
        f"{check['ties']} tie rows (bar <= 1%); max shortfall {check['shortfall']:.3e} nats")
    require(check["mismatch"] == 0, f"{what}: assignment kernel disagrees with its plain version")
    require(check["ties"] <= 0.01 * check["rows"], f"{what}: too many fp32 ties")
    return check


def require_distribution(zs, probs, what: str) -> None:
    """Per-row frequencies of reps draws zs [reps, n] against probs [n, k]."""
    reps, (n, k) = zs.shape[0], probs.shape
    counts = np.zeros((n, k))
    for zi in zs:
        counts[np.arange(n), zi] += 1
    freq = counts / reps
    max_gap = float(np.abs(freq - probs).max())
    mean_gap = float(np.abs(freq.mean(0) - probs.mean(0)).max())
    log(f"{what} x{reps} seeds: max gap {max_gap:.4f} (bar < 0.15), "
        f"mean gap {mean_gap:.4f} (bar < 0.03)")
    require(max_gap < 0.15 and mean_gap < 0.03, f"{what}: distribution off")


def _leaves(x, name: str = "end"):
    """(name, value) of every tensor, array, number and string of a state, a
    sampler's result or a tuple of them, in a fixed order."""
    import dataclasses

    import torch

    if torch.is_tensor(x) or isinstance(x, (np.ndarray, np.generic, int, float, bool, str)) or x is None:
        yield name, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{name}.{f.name}")
    elif hasattr(x, "_fields"):  # a NamedTuple
        for f in x._fields:
            yield from _leaves(getattr(x, f), f"{name}.{f}")
    elif isinstance(x, dict):  # by key: a checkpoint restores a dict's keys sorted
        for k in sorted(x, key=str):
            yield from _leaves(x[k], f"{name}.{k}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{name}[{i}]")
    else:
        raise TypeError(f"{name}: no leaves of a {type(x).__name__}")


def _same_leaf(a, b) -> bool:
    import torch

    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, (np.ndarray, np.generic)):
        return isinstance(b, (np.ndarray, np.generic)) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def require_replay(what: str, a, b) -> dict:
    """Two ends of one path from one start and one generator seed: equal bit
    for bit in every leaf (assignments, counts, every stats leaf, hypers)."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    require([n for n, _ in la] == [n for n, _ in lb], f"replay {what}: the two ends differ in structure")
    differ = [n for (n, x), (_, y) in zip(la, lb) if not _same_leaf(x, y)]
    log(f"replay {what}: {len(la)} leaves, " + ("equal bit for bit" if not differ else f"DIFFER in {differ[:8]}"))
    require(not differ, f"replay {what}: the two runs differ in {differ[:8]}")
    return {"leaves": len(la), "equal": True}


def runner_replay(what: str, defn, data, start, config, seed: int, dev) -> dict:
    """From `start` and generator seed `seed`: 2 runner steps twice, and 1
    step, a checkpoint with the generator, a restore and 1 more step; the
    three ends (state and score trace) equal bit for bit."""
    import torch

    from common_tpu_torch import io, rng
    from common_tpu_torch.runner import runner

    t0 = time.perf_counter()
    ends = []
    for _ in range(2):
        run = runner(defn, data, start, config)
        run.run(rng(seed, dev).generator, 2)
        ends.append((run.get_latent(), run.score_trace))
    g = rng(seed, dev).generator
    first = runner(defn, data, start, config)
    first.run(g, 1)
    blob = io.serialize(first.get_latent(), extra={"gen": g})
    restored, extra = io.deserialize(blob, device=dev)
    rest = runner(defn, data, restored, config)
    rest.run(extra["gen"], 1)
    resumed = (rest.get_latent(), np.concatenate([first.score_trace, rest.score_trace]))
    require_replay(f"{what}: 2 runner steps, twice", ends[0], ends[1])
    require_replay(f"{what}: 1 step, a {len(blob)}-byte checkpoint and 1 more, against 2 straight",
                   ends[0], resumed)
    torch.cuda.synchronize()
    return {"equal": True, "resume_equal": True, "s": time.perf_counter() - t0}


def replay(what: str, drive) -> dict:
    """drive() twice (each from one start and one generator seed); the two
    ends equal bit for bit."""
    import torch

    t0 = time.perf_counter()
    a = drive()
    b = drive()
    rec = require_replay(what, a, b)
    torch.cuda.synchronize()
    return {**rec, "s": time.perf_counter() - t0}


def _softmax_problem(n, d, k, seed, device):
    """Small ambiguous rows for the distribution checks: X [n, d], centers [k, d], base [k]."""
    import torch

    r = np.random.default_rng(seed)
    mu = r.normal(scale=0.8, size=(k, d))
    X = r.normal(scale=1.0, size=(n, d))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in (X, mu, r.normal(size=k))]


def _check_gaussian(dev, g) -> dict:
    import torch

    from common_tpu_torch.ops.gaussian_assign import fused_gaussian_assign, gaussian_assign_plain

    # well separated (ragged N, dense triangular B_k): both samplers are
    # near-deterministic
    n_sep = 16384 + 37
    X, mu, binv, base = _assign_problem(n_sep, 256, 64, 6.0, 5, dev)
    z = fused_gaussian_assign(X, mu, binv, base, _seed(13, dev))
    zp = gaussian_assign_plain(X, mu, binv, base, g)
    torch.cuda.synchronize()
    agree = (z == zp).double().mean().item()
    log(f"assign n={n_sep} D=256 K=64 sep=6: agreement {agree:.6f} (bar > 0.99)")
    require(agree > 0.99, f"assignment agreement {agree} <= 0.99")
    require_exact(assign_exact_check(z, X, mu, binv, base, _seed(13, dev)),
                  f"assign n={n_sep} D=256 K=64 sep=6, draw for draw")

    # clusters told apart by B_k alone: the draw of most rows changes if any
    # part of B_k is read wrongly (shown by dropping its off-diagonal part)
    X, mu, binv, base = _covariance_problem(n_sep, 256, 64, 6, dev)
    seed = _seed(21, dev)
    z = fused_gaussian_assign(X, mu, binv, base, seed)
    require_exact(assign_exact_check(z, X, mu, binv, base, seed),
                  f"assign n={n_sep} D=256 K=64 by covariance, draw for draw")
    diag = torch.diag_embed(torch.diagonal(binv, dim1=-2, dim2=-1)).contiguous()
    moved = (fused_gaussian_assign(X, mu, diag, base, seed) != z).double().mean().item()
    log(f"  share of draws that change when B_k loses its off-diagonal part: "
        f"{moved:.4f} (bar > 0.5)")
    require(moved > 0.5, "the covariance check does not depend on B_k's off-diagonal part")

    # the widest D the kernel takes, and a D that fills no panel or 16-byte row
    for n, d, k in ((4096 + 17, 384, 16), (5000 + 3, 203, 33)):
        X, mu, binv, base = _covariance_problem(n, d, k, d, dev)
        seed = _seed(d, dev)
        z = fused_gaussian_assign(X, mu, binv, base, seed)
        require_exact(assign_exact_check(z, X, mu, binv, base, seed),
                      f"assign n={n} D={d} K={k} by covariance, draw for draw")

    # distribution: per-row frequencies against the softmax
    X_s, mu_s, base_s = _softmax_problem(64, 4, 5, 1, dev)
    binv_s = torch.eye(4, device=dev).expand(5, 4, 4).contiguous()
    diff = X_s[:, None, :] - mu_s[None]
    probs = torch.softmax(base_s[None, :] - 0.5 * (diff * diff).sum(-1), dim=-1).cpu().numpy()
    zs = torch.stack([fused_gaussian_assign(X_s, mu_s, binv_s, base_s, _seed(100 + i, dev))
                      for i in range(300)]).cpu().numpy()
    require_distribution(zs, probs, "assign distribution n=64 D=4 K=5")
    return {"assign_agree": agree}


def _check_chains(dev) -> None:
    """The multi-chain kernel: draw for draw on dense B_k, C=1 against the
    single-chain kernel, and its distribution with independent chains."""
    import torch

    from common_tpu_torch.ops.gaussian_assign import (
        fused_gaussian_assign,
        fused_gaussian_assign_chains,
    )

    n, d, k, c = 16384 + 37, 256, 64, 4
    r = np.random.default_rng(7)
    X, _, _, _ = _covariance_problem(n, d, 1, 8, dev)
    mu = torch.tensor(r.normal(scale=0.3, size=(c * k, d)), dtype=torch.float32, device=dev)
    # dense and not triangular, like the Bartlett precision square root minv
    minv = torch.tensor(r.normal(scale=d ** -0.5, size=(c * k, d, d)) + np.eye(d),
                        dtype=torch.float32, device=dev)
    base = torch.tensor(r.normal(size=c * k), dtype=torch.float32, device=dev)
    seed = _seed(31, dev)
    z = fused_gaussian_assign_chains(X, mu, minv, base, seed, c)
    require_exact(chains_exact_check(z, X, mu, minv, base, seed, c),
                  f"assign_chains n={n} D={d} K={k} C={c}, dense minv, draw for draw")

    # chain 0's slots are the first K rows, so these slices are contiguous
    z1 = fused_gaussian_assign_chains(X, mu[:k], minv[:k], base[:k], seed, 1)[0]
    zk = fused_gaussian_assign(X, mu[:k], minv[:k], base[:k], seed)
    same = int((z1 == zk).sum())
    log(f"assign_chains at C=1 against the single-chain kernel: {same} of {n} rows equal (bar all)")
    require(same == n, "the multi-chain kernel at C=1 differs from the single-chain kernel")
    require(torch.equal(z[0], zk), "chain 0 of the multi-chain kernel differs from the "
                                   "single-chain kernel")

    # distribution: identical parameters in every chain, independent noise
    cd, ck, cn, cc, reps = 4, 5, 64, 3, 300
    X_s, mu0, base0 = _softmax_problem(cn, cd, ck, 1, dev)
    mu_s = mu0.repeat(cc, 1)
    binv_s = torch.eye(cd, device=dev).expand(cc * ck, cd, cd).contiguous()
    diff = X_s[:, None, :] - mu0[None]
    probs = torch.softmax(base0[None, :] - 0.5 * (diff * diff).sum(-1), dim=-1).cpu().numpy()
    zs = np.stack([fused_gaussian_assign_chains(X_s, mu_s, binv_s, base0.repeat(cc),
                                                _seed(100 + i, dev), cc).cpu().numpy()
                   for i in range(reps)])  # [reps, C, n]
    for ch in range(cc):
        require_distribution(zs[:, ch], probs, f"assign_chains distribution chain {ch}, "
                                               f"n={cn} D={cd} K={ck} C={cc}")
    agree = float((zs[:, 0] == zs[:, 1]).mean())
    expected = float((probs ** 2).sum(1).mean())
    log(f"  chains 0 and 1 agree on {agree:.4f} of draws; independent draws: {expected:.4f} "
        f"(bar |gap| < 0.1)")
    require(abs(agree - expected) < 0.1, "the chains' noise is not independent")


def _linear_problem(n, d, k, seed, device):
    """bbv-like binary rows around k Beta(0.5, 0.5) profiles: X, W = logit p, base."""
    import torch

    r = np.random.default_rng(seed)
    p = np.clip(r.beta(0.5, 0.5, size=(k, d)), 1e-3, 1 - 1e-3)
    X = (r.random((n, d)) < p[r.integers(0, k, n)]).astype(np.float32)
    W = np.log(p) - np.log1p(-p)
    base = np.log1p(-p).sum(-1) + np.log(r.dirichlet(np.ones(k)))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in (X, W, base)]


def _check_linear(dev) -> None:
    import torch

    from common_tpu_torch.ops.linear_assign import fused_linear_assign

    for n, d, k, seed in ((N2, D2, K2, 41), (5000 + 13, 300, 33, 43), (100, 61, 70, 47),
                          (1_000_003, D2, K2, 53)):
        X, W, base = _linear_problem(n, d, k, seed, dev)
        z = fused_linear_assign(X, W, base, _seed(seed, dev))
        require_exact(linear_exact_check(z, X, W, base, _seed(seed, dev)),
                      f"linear_assign n={n} D={d} K={k}, draw for draw")

    X_s, W_s, base_s = _softmax_problem(64, 4, 5, 2, dev)
    probs = torch.softmax(X_s @ W_s.T + base_s, dim=-1).cpu().numpy()
    zs = torch.stack([fused_linear_assign(X_s, W_s, base_s, _seed(100 + i, dev))
                      for i in range(300)]).cpu().numpy()
    require_distribution(zs, probs, "linear_assign distribution n=64 D=4 K=5")


def _check_scatter(dev, g) -> None:
    import torch

    from common_tpu_torch.ops.suffstat import fused_scatter_stats, scatter_stats_plain

    # at the main path's size, masked rows and a ragged N
    n_big = N + 37
    r = np.random.default_rng(3)
    Xb = torch.randn((n_big, D), generator=g, device=dev)
    zb = torch.tensor(r.integers(-1, K_MAX + 1, n_big), dtype=torch.int32, device=dev)
    got = fused_scatter_stats(Xb, zb, K_MAX)
    want = scatter_stats_plain(Xb, zb, K_MAX)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    symmetric = torch.equal(got, got.transpose(1, 2))
    log(f"scatter N={n_big} D={D} K={K_MAX}: max|kernel - plain| {err:.3e}, "
        f"bar 1e-4 * {scale:.3e}; equal to its transpose bit for bit: {symmetric}")
    require(err <= 1e-4 * scale, "scatter stats disagree at full size")
    require(symmetric, "scatter stats are not exactly symmetric")
    del Xb, zb, got, want

    # at a small shape against float64 on the host
    r = np.random.default_rng(4)
    Xs = r.normal(size=(1000, 20)).astype(np.float32)
    zsm = r.integers(-1, 8, 1000).astype(np.int32)  # -1 and 7 = K: dropped
    got = fused_scatter_stats(torch.from_numpy(Xs).to(dev), torch.from_numpy(zsm).to(dev), 7)
    X64 = Xs.astype(np.float64)
    want = np.stack([X64[zsm == c].T @ X64[zsm == c] for c in range(7)])
    err = float(np.abs(got.cpu().numpy() - want).max())
    log(f"scatter N=1000 D=20 K=7 vs float64: max abs err {err:.3e} "
        f"(bar 1e-5 * {np.abs(want).max():.3e})")
    require(err <= 1e-5 * np.abs(want).max(), "scatter stats disagree with float64")


def phase_kernels() -> dict:
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = _check_gaussian(dev, g)
    _check_chains(dev)
    _check_linear(dev)
    _check_scatter(dev, g)
    return out


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
def headline_data():
    """The 1M x 256 rows of phases 3, 4 and 12, 4096 held-out rows, and the NIW hypers.

    8 planted centers at scale 4 plus unit noise (bench.py make_data_device),
    hypers mu0 = 0, kappa = 1, psi = I, nu = D + 2 (bench.py:270-275).
    """
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    r = np.random.default_rng(SEED)
    centers = 4.0 * r.standard_normal((8, D), dtype=np.float32)
    X_all = centers[r.integers(0, 8, N + HELDOUT)]
    X_all += r.standard_normal((N + HELDOUT, D), dtype=np.float32)
    x = torch.from_numpy(X_all[:N]).to(dev)
    xh = torch.from_numpy(X_all[N:]).to(dev)
    del X_all
    torch.cuda.synchronize()
    log(f"data {N}x{D} + {HELDOUT} held out: {time.perf_counter() - t0:.2f} s (host numpy)")
    hyper = {"mu0": np.zeros(D, np.float32), "kappa": 1.0,
             "psi": np.eye(D, dtype=np.float32), "nu": float(D + 2)}
    return {"data": ((x, torch.ones(N, device=dev)),),
            "heldout": ((xh, torch.ones(HELDOUT, device=dev)),), "hyper": hyper}


def phase_main_path(kernel_checks: dict, headline: dict) -> dict:
    import torch

    from common_tpu_torch import models, rng, state as st
    from common_tpu_torch.kernels import blocked
    from common_tpu_torch.ops import gaussian_assign as ga
    from common_tpu_torch.ops import suffstat as ss
    from common_tpu_torch.runner import runner

    dev = torch.device("cuda")
    data, hyper = headline["data"], headline["hyper"]
    x, mask = data[0]
    defn = st.model_definition(N, [models.niw(D)], k_max=K_MAX)
    gen = rng(SEED, dev).generator
    t0 = time.perf_counter()
    s0 = st.initialize(defn, data, gen, cluster_hp={"alpha": 1.0}, feature_hps=[hyper])
    torch.cuda.synchronize()
    log(f"initialize (CRP draw on the host + stats): {time.perf_counter() - t0:.2f} s, "
        f"k_active {int((s0.counts > 0).sum())}")
    t0 = time.perf_counter()
    st.sample_crp_assignment(rng(SEED + 1, dev).generator, N, K_MAX, torch.tensor(1.0))
    log(f"  of which the CRP host loop alone: {time.perf_counter() - t0:.2f} s")

    run = runner(defn, data, s0, [("assign_blocked_fused", {})])
    t0 = time.perf_counter()
    run.run(gen, 1)
    torch.cuda.synchronize()
    log(f"first fused sweep, with one-time CUDA library set-up: {time.perf_counter() - t0:.2f} s")
    ga.fused_gaussian_assign.launches = ga.fused_gaussian_assign.wgmma = 0
    ss.fused_scatter_stats.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.run(gen, N_SWEEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"gaussian_assign": ga.fused_gaussian_assign.launches,
                "suffstat": ss.fused_scatter_stats.launches}
    log(f"runner.run({N_SWEEPS} fused sweeps): {run_s:.3f} s, "
        f"{N_SWEEPS / run_s:.3f} sweeps/s (with the score trace); launches {launches}, "
        f"of kernel 1 on the warpgroup route {ga.fused_gaussian_assign.wgmma}")
    require(all(v == N_SWEEPS for v in launches.values()),
            f"kernel launches {launches} != {N_SWEEPS} sweeps")
    require(ga.fused_gaussian_assign.wgmma == N_SWEEPS, "kernel 1 left the warpgroup route at D = 256")

    scores = run.score_trace[1:]
    k_active = run.k_active_trace[1:]
    log(f"score_joint trace: {scores.tolist()}")
    log(f"k_active trace: {k_active.tolist()}")
    require(np.isfinite(scores).all(), "non-finite score_joint")
    require(int(k_active[-1]) >= 2, f"k_active {k_active[-1]} < 2")
    s = run.get_latent()
    require(int(s.counts.sum()) == N, "counts do not sum to N")

    plain = blocked.restat(s, data, s.assignments)
    for leaf in ("n", "sum_x", "sum_xxT"):
        a, b = s.stats[0][leaf], plain.stats[0][leaf]
        err = (a - b).abs().max().item()
        bar = 1e-4 * b.abs().max().item()
        log(f"final stats {leaf}: max|fused - plain restat| {err:.3e} (bar {bar:.3e})")
        require(err <= bar, f"final {leaf} disagrees with the plain restat")
    require(torch.equal(s.counts, plain.counts), "counts disagree with the plain restat")

    t0 = time.perf_counter()
    lp = st.heldout_logp(s, headline["heldout"])
    lp_dim = lp.mean().item() / D
    log(f"held-out logp/dim ({HELDOUT} rows): {lp_dim:.5f} "
        f"({time.perf_counter() - t0:.2f} s)")
    require(np.isfinite(lp_dim), "held-out logp is not finite")

    # whole sweeps, in turns: fused, plain, plain, fused, fused, plain
    times = {"fused": [], "plain": []}
    for kind in ("fused", "plain", "plain", "fused", "fused", "plain"):
        fn = blocked.sweep_fused if kind == "fused" else blocked.sweep
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(s, data, gen)
        torch.cuda.synchronize()
        times[kind].append(1e3 * (time.perf_counter() - t0))
    fused_ms, plain_ms = (float(np.median(times[k])) for k in ("fused", "plain"))
    log(f"sweep ms, median of 3: fused {fused_ms:.1f} {times['fused']}, "
        f"plain {plain_ms:.1f} {times['plain']}")

    # each kernel against its plain version, on this sweep's own inputs
    mu, binv, base, _ = blocked.fused_assign_inputs(s, data, gen)
    seed = _seed(7, dev)
    exact = assign_exact_check(ga.fused_gaussian_assign(x, mu, binv, base, seed),
                               x, mu, binv, base, seed)
    require_exact(exact, f"assign on the main path's inputs ({N}x{D}, K={K_MAX}), draw for draw")
    zi = torch.where(mask > 0, s.assignments, K_MAX).to(torch.int32)
    old_route = mma_sync_route(x, mu, binv, base, seed)
    require_exact(assign_exact_check(old_route(), x, mu, binv, base, seed),
                  f"assign on the mma.sync route, main path's inputs, draw for draw")
    k1, m1, turns1 = route_turns(lambda: ga.fused_gaussian_assign(x, mu, binv, base, seed), old_route, 3)
    p1 = cuda_ms(lambda: ga.gaussian_assign_plain(x, mu, binv, base, gen), 2)
    y1 = gaussian_yardsticks(x, mu, binv)
    log(f"gaussian_assign {N}x{D} K={K_MAX}: warpgroup route {k1:.2f} ms, mma.sync route {m1:.2f} ms "
        f"(in turns {turns1}), plain {p1:.2f} ms; bound {y1['bound_ms']:.2f} ms ({y1['bound_by']}, 3xTF32; "
        f"fp32 CUDA cores {y1['bound_fp32_ms']:.2f} ms), share {y1['bound_ms'] / k1:.3f} (mma.sync "
        f"{y1['bound_ms'] / m1:.3f}); library {y1['library']}: {y1['library_ms']:.2f} ms")

    # kernel 2: the sort and the kernels timed apart; float64 on the largest cluster
    order, offsets = ss.sort_by_cluster(zi, K_MAX)
    sort_ms = cuda_ms(lambda: ss.sort_by_cluster(zi, K_MAX), 5)
    k2 = cuda_ms(lambda: ss.scatter_sorted(x, order, offsets), 5)
    w2 = cuda_ms(lambda: ss.fused_scatter_stats(x, zi, K_MAX), 3)
    p2 = cuda_ms(lambda: ss.scatter_stats_plain(x, zi, K_MAX), 2)
    lib2 = cuda_ms(lambda: torch.mm(x.T, x), 3)
    got = ss.fused_scatter_stats(x, zi, K_MAX)
    err2 = (got - ss.scatter_stats_plain(x, zi, K_MAX)).abs().max().item()
    counts = offsets[1:] - offsets[:-1]
    kbig = int(torch.argmax(counts))
    rows = x[order[int(offsets[kbig]):int(offsets[kbig + 1])].long()].double()
    want64 = rows.T @ rows
    rel64 = ((got[kbig].double() - want64).abs().max() / want64.abs().max()).item()
    symmetric = torch.equal(got, got.transpose(1, 2))
    n_in = int(offsets[-1])
    y2 = {**bound(float(n_in) * D * (D + 1), 4.0 * (N * D + N + K_MAX * D * D)),
          "library_ms": lib2, "library": f"torch.mm(X.T, X), X [{N}, {D}], fp32"}
    log(f"scatter_stats {N}x{D} K={K_MAX} (main-path z): kernels {k2:.3f} ms, sort and search "
        f"{sort_ms:.3f} ms, the whole wrapper {w2:.3f} ms; plain {p2:.2f} ms; max abs err {err2:.3e}; "
        f"bound {y2['bound_ms']:.3f} ms ({y2['bound_by']}, 3xTF32; fp32 CUDA cores "
        f"{y2['bound_fp32_ms']:.3f} ms), share {y2['bound_ms'] / k2:.3f}; library {y2['library']}: "
        f"{lib2:.3f} ms")
    log(f"scatter_stats on the largest cluster ({rows.shape[0]} rows) against float64 on the card: "
        f"{rel64:.3e} relative (bar 1e-5); sum_xxT equal to its transpose bit for bit: {symmetric}")
    require(rel64 <= 1e-5, "scatter stats off float64 on the largest cluster")
    require(symmetric, "scatter stats are not exactly symmetric")
    del rows, want64, got
    replayed = runner_replay(f"main path ({N}x{D}, K_max={K_MAX})", defn, data, s, [("assign_blocked_fused", {})],
                             SEED + 300, dev)
    idle, _ = profile_sweep(lambda: run.run(gen, 1))
    # phases 7 and 8 start from this chain: its best joint score bounds
    # block-SMC's log Z, and split-merge moves its final state
    headline["state3"] = run.get_latent()
    headline["best_joint3"] = float(np.max(run.score_trace))
    return {
        "kernels": [
            {"name": "gaussian_assign", "route": "cuda",
             "source": "common_tpu_torch/csrc/gaussian_assign.cu",
             "replaces": "common_tpu/ops/gaussian_assign.py:101",
             "launches": launches["gaussian_assign"],
             "max_abs_err": exact["shortfall"],
             "mismatch": exact["mismatch"], "tie_rows": exact["ties"],
             "agree": kernel_checks["assign_agree"],
             "ms": k1, "mma_sync_ms": m1, "plain_ms": p1, **y1},
            {"name": "scatter_stats", "route": "cuda",
             "source": "common_tpu_torch/csrc/suffstat.cu",
             "replaces": "common_tpu/ops/suffstat.py:75",
             "launches": launches["suffstat"],
             "max_abs_err": err2, "f64_rel_err": rel64, "symmetric": symmetric,
             "ms": k2, "sort_ms": sort_ms, "wrapper_ms": w2, "plain_ms": p2, **y2},
        ],
        "sweeps_per_s": N_SWEEPS / run_s,
        "fused_sweep_ms": fused_ms, "plain_sweep_ms": plain_ms,
        "heldout_logp_per_dim": lp_dim, "idle_share": idle, "replay": replayed,
    }


# ---------------------------------------------------------------------------
# phase 4: path A, multi-chain
# ---------------------------------------------------------------------------
def phase_chains(headline: dict) -> dict:
    import torch

    from common_tpu_torch import models, rng, state as st
    from common_tpu_torch.kernels import blocked
    from common_tpu_torch.ops import gaussian_assign as ga
    from common_tpu_torch.ops import suffstat as ss
    from common_tpu_torch.parallel import stack_states, unstack_state
    from common_tpu_torch.utils import diagnostics

    dev = torch.device("cuda")
    data, heldout, hyper = headline["data"], headline["heldout"], headline["hyper"]
    x, mask = data[0]
    C = N_CHAINS
    defn = st.model_definition(N, [models.niw(D)], k_max=K_MAX)
    gen = rng(SEED + 2, dev).generator
    t0 = time.perf_counter()
    states = stack_states([
        st.initialize(defn, data, gen, cluster_hp={"alpha": 1.0}, feature_hps=[hyper])
        for _ in range(C)])
    torch.cuda.synchronize()
    log(f"chains: {C} CRP initialisations, stacked: {time.perf_counter() - t0:.2f} s, "
        f"k_active {(states.counts > 0).sum(-1).tolist()}")

    t0 = time.perf_counter()
    states = blocked.sweep_chains(states, data, gen, fused=True)
    torch.cuda.synchronize()
    log(f"first sweep_chains(fused=True): {time.perf_counter() - t0:.2f} s")

    ga.fused_gaussian_assign_chains.launches = ga.fused_gaussian_assign_chains.wgmma = 0
    ss.fused_scatter_stats.launches = 0
    sweep_ms, score_tr, lp_tr = [], [], []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for _ in range(CHAIN_SWEEPS):
        t0 = time.perf_counter()
        states = blocked.sweep_chains(states, data, gen, fused=True)
        torch.cuda.synchronize()
        sweep_ms.append(1e3 * (time.perf_counter() - t0))
        chains = [unstack_state(states, c) for c in range(C)]
        score_tr.append(torch.stack([st.score_joint(s) for s in chains]))
        lp_tr.append(torch.stack([st.heldout_logp(s, heldout).mean() for s in chains]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_all
    launches = {"gaussian_assign_chains": ga.fused_gaussian_assign_chains.launches,
                "suffstat": ss.fused_scatter_stats.launches}
    log(f"{CHAIN_SWEEPS} sweeps of {C} chains with per-chain scores and held-out logp: "
        f"{run_s:.3f} s, {C * CHAIN_SWEEPS / run_s:.3f} chain-sweeps/s; sweep_chains alone "
        f"{[round(t, 1) for t in sweep_ms]} ms; launches {launches}")
    require(launches["gaussian_assign_chains"] == CHAIN_SWEEPS == ga.fused_gaussian_assign_chains.wgmma,
            f"multi-chain kernel launches {launches} != {CHAIN_SWEEPS} sweeps on the warpgroup route "
            f"({ga.fused_gaussian_assign_chains.wgmma})")
    require(launches["suffstat"] == C * CHAIN_SWEEPS,
            f"scatter launches {launches} != {C} chains x {CHAIN_SWEEPS} sweeps")

    scores = torch.stack(score_tr).T.cpu().numpy()  # [C, T]
    lps = torch.stack(lp_tr).T.cpu().numpy() / D
    log(f"score_joint traces: {scores.tolist()}")
    log(f"held-out logp/dim traces: {lps.tolist()}")
    require(np.isfinite(scores).all() and np.isfinite(lps).all(), "non-finite chain traces")
    require(states.counts.sum(-1).tolist() == [N] * C, "counts do not sum to N per chain")
    for leaf, v in states.stats[0].items():
        require(bool(torch.isfinite(v).all()), f"non-finite stats {leaf}")
    for c in range(C):
        s = unstack_state(states, c)
        plain = blocked.restat(s, data, s.assignments)
        require(torch.equal(s.counts, plain.counts), f"chain {c}: counts disagree with the plain restat")
        for leaf in ("n", "sum_x", "sum_xxT"):
            a, b = s.stats[0][leaf], plain.stats[0][leaf]
            err = (a - b).abs().max().item()
            bar = 1e-4 * b.abs().max().item()
            require(err <= bar, f"chain {c}: {leaf} off the plain restat by {err:.3e} (bar {bar:.3e})")
    log(f"per-chain stats within 1e-4 of the plain restat (n, sum_x, sum_xxT); "
        f"k_active {(states.counts > 0).sum(-1).tolist()}")
    rhat = float(diagnostics.split_rhat(lps))
    ess = float(diagnostics.ess(scores - scores.mean(1, keepdims=True)))
    log(f"split-R-hat of the held-out traces {rhat:.4f}, ESS of the centred score traces "
        f"{ess:.2f} ({CHAIN_SWEEPS} sweeps: a smoke number, not a mixing claim)")

    # the kernel against its plain version, on this sweep's own inputs
    mu, minv, base, _ = blocked.chain_assign_inputs(states, data, gen)
    seed = _seed(7, dev)
    z = ga.fused_gaussian_assign_chains(x, mu, minv, base, seed, C)
    exact = require_exact(chains_exact_check(z, x, mu, minv, base, seed, C),
                          f"assign_chains on path A's inputs ({N}x{D}, K={K_MAX}, C={C}), "
                          f"draw for draw")
    old_route = mma_sync_route(x, mu, minv, base, seed, C)
    require_exact(chains_exact_check(old_route(), x, mu, minv, base, seed, C),
                  f"assign_chains on the mma.sync route, path A's inputs, draw for draw")
    k4, m4, turns4 = route_turns(lambda: ga.fused_gaussian_assign_chains(x, mu, minv, base, seed, C),
                                 old_route, 2)
    p4 = cuda_ms(lambda: ga.gaussian_assign_chains_plain(x, mu, minv, base, C, gen), 2)
    y4 = gaussian_yardsticks(x, mu, minv, C)
    log(f"gaussian_assign_chains {N}x{D} K={K_MAX} C={C}: warpgroup route {k4:.2f} ms, mma.sync route "
        f"{m4:.2f} ms (in turns {turns4}), plain {p4:.2f} ms; bound {y4['bound_ms']:.2f} ms "
        f"({y4['bound_by']}, 3xTF32; fp32 CUDA cores {y4['bound_fp32_ms']:.2f} ms), share "
        f"{y4['bound_ms'] / k4:.3f} (mma.sync {y4['bound_ms'] / m4:.3f}); library {y4['library']}: "
        f"{y4['library_ms']:.2f} ms")
    replayed = replay(f"path A: 1 sweep_chains of {C} chains",
                      lambda: blocked.sweep_chains(states, data, rng(SEED + 301, dev).generator, fused=True))
    idle, _ = profile_sweep(lambda: blocked.sweep_chains(states, data, gen, fused=True))
    return {
        "kernel": {"name": "gaussian_assign_chains", "route": "cuda",
                   "source": "common_tpu_torch/csrc/gaussian_assign.cu",
                   "replaces": "common_tpu/ops/gaussian_assign.py:214",
                   "launches": launches["gaussian_assign_chains"],
                   "max_abs_err": exact["shortfall"],
                   "mismatch": exact["mismatch"], "tie_rows": exact["ties"],
                   "ms": k4, "mma_sync_ms": m4, "plain_ms": p4, **y4},
        "chain_sweeps_per_s": C * CHAIN_SWEEPS / run_s,
        "sweep_chains_ms": float(np.median(sweep_ms)),
        "split_rhat": rhat, "ess": ess,
        "heldout_logp_per_dim": lps[:, -1].tolist(), "idle_share": idle, "replay": replayed,
    }


# ---------------------------------------------------------------------------
# phase 7: BASELINE config 5 by block-SMC
# ---------------------------------------------------------------------------
def _all_kernels():
    from common_tpu_torch.ops import gaussian_assign as ga
    from common_tpu_torch.ops import hdp_assign as ha
    from common_tpu_torch.ops import linear_assign as la
    from common_tpu_torch.ops import slice_update as su
    from common_tpu_torch.ops import suffstat as ss

    return (ga.fused_gaussian_assign, ga.fused_gaussian_assign_chains, la.fused_linear_assign,
            ss.fused_scatter_stats, su.slice_update, ha.hdp_assign)


def _zero_launches() -> None:
    for k in _all_kernels():
        k.launches = 0


def _launches() -> dict:
    return {k.__name__: k.launches for k in _all_kernels()}


def require_bookkeeping(s, data, what: str, K: int) -> dict:
    """counts = a bincount of z, stats within 1e-4 of a plain restat (of the
    largest entry), empty slots exactly zero; returns the errors."""
    import torch

    from common_tpu_torch import state as st
    from common_tpu_torch.kernels import blocked

    require(torch.equal(s.counts, st._assignment_counts(s.assignments, K)), f"{what}: counts are not a bincount of z")
    plain = blocked.restat(s, data, s.assignments)
    errs = {}
    for f, stats_f in enumerate(plain.stats):
        for leaf, b in stats_f.items():
            a = s.stats[f][leaf]
            name = leaf if len(plain.stats) == 1 else f"{f}.{leaf}"
            errs[name] = (a - b).abs().max().item()
            require(errs[name] <= 1e-4 * b.abs().max().item(),
                    f"{what}: {name} off the plain restat by {errs[name]:.3e}")
            require(bool((a[s.counts == 0] == 0).all()), f"{what}: an empty slot's {name} is not exactly zero")
    log(f"{what}: counts a bincount of z; max|stats - plain restat| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (bar 1e-4 of the largest entry); empty slots 0")
    return errs


def phase_smc(headline: dict) -> dict:
    """Config 5: `smc.run_blocked` over phase 3's rows at the JAX record's settings.

    Kernel 2 launches: the seat of each block once, and each rejuvenation
    window twice (its new and its old assignment), so (1 + 2 * REJUV7) a
    block over ceil((N - WARMUP7) / BLOCK7) blocks; the warmup rows (fewer
    than a block) add none.
    """
    import torch

    from common_tpu_torch import models, rng, state as st
    from common_tpu_torch.kernels import smc
    from common_tpu_torch.ops import suffstat as ss
    from common_tpu_torch.parallel import unstack_state

    dev = torch.device("cuda")
    data, heldout, hyper = headline["data"], headline["heldout"], headline["hyper"]
    x, _ = data[0]
    defn = st.model_definition(N, [models.niw(D)], k_max=K_MAX)
    gen = rng(SEED + 7, dev).generator
    t0 = time.perf_counter()
    parts = smc.init_particles(defn, data, gen, P7, cluster_hp={"alpha": 1.0}, feature_hps=[hyper])
    torch.cuda.synchronize()
    log(f"config 5: {P7} empty particles: {time.perf_counter() - t0:.2f} s")
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = smc.run_blocked(parts, data, gen, block=BLOCK7, warmup=WARMUP7, rejuvenation_blocks=REJUV7)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launches()
    n_blocks = -(-(N - WARMUP7) // BLOCK7)
    expected = n_blocks * (1 + 2 * REJUV7)
    log(f"run_blocked(P={P7}, block={BLOCK7}, warmup={WARMUP7}, rejuvenation_blocks={REJUV7}) at "
        f"{N}x{D}, K_max={K_MAX}: {wall:.2f} s, {N / wall:.1f} rows/s; launches {launched} "
        f"(scatter expected {expected} = {n_blocks} blocks x {1 + 2 * REJUV7})")
    require(launched["fused_scatter_stats"] == expected,
            f"scatter launches {launched['fused_scatter_stats']} != {expected}")
    require(sum(launched.values()) == expected, f"another kernel ran in block-SMC: {launched}")

    p = res.particles
    require(p.counts.sum(-1).tolist() == [N] * P7, "a particle does not seat all N rows")
    for i in range(P7):
        require(torch.equal(p.counts[i], st._assignment_counts(p.assignments[i], K_MAX)),
                f"particle {i}: counts are not a bincount of its z")
    log(f"every particle seats {N} rows; counts a bincount of z; k_active {(p.counts > 0).sum(-1).tolist()}")
    top = int(torch.argmax(res.log_w))
    errs = require_bookkeeping(unstack_state(p, top), data, f"top-weight particle {top}", K_MAX)

    logz, joint = float(res.logz), headline["best_joint3"]
    ess = res.ess_trace.numpy()
    low = int((ess < 2).sum())
    log(f"logz {logz:.6e}; phase 3's best joint {joint:.6e}; logz - joint {logz - joint:.6e} "
        f"(bar >= -{SLACK7} x |joint| = {-SLACK7 * abs(joint):.1f}); n_resamples {res.n_resamples} of "
        f"{len(ess)} steps; ESS min {ess.min():.3f}, median {np.median(ess):.3f}, {low} steps below 2 "
        f"(bar <= half)")
    require(np.isfinite(logz) and logz >= joint - SLACK7 * abs(joint), "logz below the joint bound")
    require(low <= len(ess) / 2, f"{low} of {len(ess)} steps with ESS < 2")
    log("JAX record, history from other data on a TPU (BENCH_MEASURED_R5.json:91-118): logz -3.673e8, "
        "76 resamples of 251 steps, held-out -1.42593 logp/dim")

    # held-out density of the weighted cloud: log sum_p w_p p(x* | particle p)
    t0 = time.perf_counter()
    logw = torch.log_softmax(res.log_w, -1)
    lps = torch.stack([st.heldout_logp(unstack_state(p, i), heldout) for i in range(P7)])  # [P, 4096]
    lp_dim = torch.logsumexp(logw[:, None] + lps.double(), 0).mean().item() / D
    log(f"weighted cloud held-out logp/dim ({HELDOUT} rows): {lp_dim:.5f} ({time.perf_counter() - t0:.2f} s); "
        f"the JAX record's -1.42593 is history from other data")
    require(np.isfinite(lp_dim), "held-out logp is not finite")

    # kernel 2 on one block's own inputs: the last full block of the final cloud
    off = WARMUP7 + (n_blocks - 2) * BLOCK7
    xb = x[off:off + BLOCK7]
    zb = p.assignments[:, off:off + BLOCK7]
    flat = (zb + torch.arange(P7, device=dev)[:, None] * K_MAX).reshape(-1).to(torch.int32)
    xr = xb.repeat(P7, 1)
    got = ss.fused_scatter_stats(xr, flat, P7 * K_MAX)
    want = ss.scatter_stats_plain(xr, flat, P7 * K_MAX)
    err = (got - want).abs().max().item()
    log(f"scatter on one SMC block ({P7} x {BLOCK7} rows, {P7 * K_MAX} slots): max|kernel - plain| "
        f"{err:.3e} (bar 1e-4 x {want.abs().max().item():.3e})")
    require(err <= 1e-4 * want.abs().max().item(), "scatter kernel disagrees on an SMC block")
    del got, want
    k2 = cuda_ms(lambda: ss.fused_scatter_stats(xr, flat, P7 * K_MAX), 5)
    p2 = cuda_ms(lambda: ss.scatter_stats_plain(xr, flat, P7 * K_MAX), 1)
    lib2 = cuda_ms(lambda: torch.mm(xr.T, xr), 5)
    rows = xr.shape[0]
    # the function's own bytes: the block's rows once, each particle's z, the
    # P * K scatter matrices; the kernel reads the rows P times (the repeat)
    y2 = {**bound(float(rows) * D * (D + 1), 4.0 * (BLOCK7 * D + rows + P7 * K_MAX * D * D)),
          "library_ms": lib2, "library": f"torch.mm(X.T, X), X [{rows}, {D}], fp32"}
    log(f"scatter_stats on one SMC block: the whole wrapper {k2:.3f} ms, plain {p2:.2f} ms, bound "
        f"{y2['bound_ms']:.3f} ms ({y2['bound_by']}), library {lib2:.3f} ms")

    # one block step (seat + rejuvenation) on the final cloud, traced; results discarded
    cols = ((xb, data[0][1][off:off + BLOCK7]),)
    valid = torch.ones(BLOCK7, dtype=torch.bool, device=dev)

    def block_step():
        q, _, _ = smc._seat_block(p, cols, valid, gen)
        smc._rejuv_block(q, cols, zb, valid, gen)

    idle, _ = profile_sweep(block_step)

    # replay on the first REPLAY7 rows (cut for time)
    cut = tuple((c[:REPLAY7], m[:REPLAY7]) for c, m in data)
    parts5 = smc.init_particles(st.model_definition(REPLAY7, [models.niw(D)], k_max=K_MAX), cut,
                                rng(SEED + 303, dev).generator, P7, cluster_hp={"alpha": 1.0}, feature_hps=[hyper])
    replayed = replay(f"config 5: run_blocked on the first {REPLAY7} rows",
                      lambda: smc.run_blocked(parts5, cut, rng(SEED + 304, dev).generator, block=BLOCK7,
                                              warmup=WARMUP7, rejuvenation_blocks=REJUV7))
    return {
        "kernel": {"name": "scatter_stats (block-SMC)", "route": "cuda",
                   "source": "common_tpu_torch/csrc/suffstat.cu",
                   "replaces": "common_tpu/ops/suffstat.py:75",
                   "launches": launched["fused_scatter_stats"], "max_abs_err": err,
                   "ms": k2, "plain_ms": p2, **y2},
        "wall_s": wall, "rows_per_s": N / wall, "logz": logz, "best_joint3": joint,
        "n_resamples": res.n_resamples, "steps": len(ess), "ess_min": float(ess.min()),
        "ess_median": float(np.median(ess)), "ess_below_2": low, "heldout_logp_per_dim": lp_dim,
        "top_particle_stats_err": errs, "idle_share": idle, "replay": replayed,
    }


# ---------------------------------------------------------------------------
# phase 8: split-merge at 1M x 256
# ---------------------------------------------------------------------------
def phase_splitmerge(headline: dict) -> dict:
    """Split-merge on phase 3's final state through the runner: one fused
    sweep, then MOVES8 moves at t_scans = SCANS8. Kernel 2 launches: one for
    the sweep's restat, and per move t_scans + 2 (the anchor seeding, the
    scans, the final scan) plus one for a split's proposal: 5 a merge and 6
    a split at SCANS8 = 3, so 1 + (SCANS8 + 2) * merges + (SCANS8 + 3) *
    splits, with the kinds from `splitmerge.move.proposed`. Then MOVES8 more
    moves one at a time, timed, each held to its own kind's count."""
    import torch

    from common_tpu_torch import models, rng, state as st
    from common_tpu_torch.kernels import splitmerge
    from common_tpu_torch.ops import suffstat as ss
    from common_tpu_torch.runner import runner

    dev = torch.device("cuda")
    data = headline["data"]
    defn = st.model_definition(N, [models.niw(D)], k_max=K_MAX)
    gen = rng(SEED + 8, dev).generator
    run = runner(defn, data, headline["state3"], [("assign_blocked_fused", {}),
                                                  ("split_merge", {"n_moves": MOVES8, "t_scans": SCANS8})])
    proposed = splitmerge.move.proposed
    _zero_launches()
    proposed.update(split=0, merge=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.run(gen, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launches()
    splits, merges = proposed["split"], proposed["merge"]
    expected = 1 + (SCANS8 + 2) * merges + (SCANS8 + 3) * splits
    log(f"runner [assign_blocked_fused, split_merge(n_moves={MOVES8}, t_scans={SCANS8})] at {N}x{D}: "
        f"{wall:.2f} s; launches {launched}; {splits} split and {merges} merge proposals, so scatter "
        f"expected {expected} = 1 + {SCANS8 + 2} x {merges} + {SCANS8 + 3} x {splits}")
    require(splits + merges == MOVES8 and launched["fused_scatter_stats"] == expected
            and launched["fused_gaussian_assign"] == 1,
            f"launches {launched} do not match one sweep, {merges} merges and {splits} splits")
    s = run.get_latent()
    require(int(s.counts.sum()) == N and np.isfinite(run.score_trace).all(), "bad counts or score")
    errs = require_bookkeeping(s, data, "after the sweep and the moves", K_MAX)

    ms, kinds = [], []
    for _ in range(MOVES8):
        before_k, before_n = int((s.counts > 0).sum()), ss.fused_scatter_stats.launches
        before_split = proposed["split"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = splitmerge.move(s, data, gen, t_scans=SCANS8)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        split = proposed["split"] > before_split
        n_move = ss.fused_scatter_stats.launches - before_n
        require(n_move == SCANS8 + 2 + split, f"a {'split' if split else 'merge'} launched the scatter {n_move} times")
        moved = int((s.counts > 0).sum()) - before_k
        kinds.append(("split" if split else "merge") + (" accepted" if moved else " rejected"))
    require_bookkeeping(s, data, "after the timed moves", K_MAX)
    log(f"{MOVES8} timed moves: {[round(t, 1) for t in ms]} ms, {kinds}; k_active {int((s.counts > 0).sum())}")
    return {"runner_s": wall, "launches": launched, "split_proposals": splits, "merge_proposals": merges,
            "move_ms": ms, "moves": kinds,
            "stats_err": errs, "k_active": int((s.counts > 0).sum())}


# ---------------------------------------------------------------------------
# phase 5: path B, config 2 (Beta-Bernoulli DPMM + slice-sampled hypers)
# ---------------------------------------------------------------------------
def noise_line(need: dict, k: int) -> str:
    return (f"{need['calls']:.4f} Philox calls of {-(-k // 4)} and {need['draws']:.4f} Gumbel draws "
            f"of {k} a row; {need['single']:.4f} of the rows have a single cluster within reach")


def linear_times(x, W, base, seed) -> dict:
    """Kernel 3 and torch.addmm on the same inputs: back to back (`ms`),
    on the card alone (`device_ms`) and L2-cold (`ms_cold`)."""
    import torch

    from common_tpu_torch.ops import linear_assign as la

    def kernel3():
        return la.fused_linear_assign(x, W, base, seed)

    def library3():
        return torch.addmm(base, x, W.T)

    return {"ms": cuda_ms(kernel3, 20), "device_ms": queued_ms(kernel3, 20), "ms_cold": cold_ms(kernel3, 20),
            "library_ms": cuda_ms(library3, 20), "library_device_ms": queued_ms(library3, 20),
            "library_ms_cold": cold_ms(library3, 20)}


def linear_at_start(s0, data, x, dev) -> dict:
    """Kernel 3 on the CRP start's inputs (its own generator, so the driven
    run is untouched): draw for draw, timed, and the noise they need."""
    from common_tpu_torch import rng
    from common_tpu_torch.kernels import blocked
    from common_tpu_torch.ops import linear_assign as la

    W, base, _ = blocked.linear_assign_inputs(s0, data, rng(SEED + 5, dev).generator)
    seed = _seed(11, dev)
    exact = require_exact(linear_exact_check(la.fused_linear_assign(x, W, base, seed), x, W, base, seed),
                          f"linear_assign on path B's CRP start ({N2}x{D2}, K={K2}), draw for draw")
    out = {**linear_times(x, W, base, seed), "mismatch": exact["mismatch"],
           "noise_need": la.noise_work(x, W, base)}
    log(f"linear_assign at the CRP start: kernel {out['ms']:.4f} ms back to back, "
        f"{out['device_ms']:.4f} ms on the card alone, L2-cold {out['ms_cold']:.4f} ms; torch.addmm "
        f"{out['library_ms']:.4f} / {out['library_device_ms']:.4f} / {out['library_ms_cold']:.4f} ms")
    log(f"  noise these inputs need, worked out in Python: {noise_line(out['noise_need'], K2)}")
    return out


def phase_config2() -> dict:
    import torch

    from common_tpu_torch import models, rng, scalar_functions as sf, state as st
    from common_tpu_torch.kernels import blocked, slice_
    from common_tpu_torch.ops import linear_assign as la
    from common_tpu_torch.ops import slice_update as su
    from common_tpu_torch.runner import runner

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    # bench.py:779-807: 8 planted Beta(0.5, 0.5) profiles over 64 binary columns
    r = np.random.default_rng(SEED)
    probs = r.beta(0.5, 0.5, size=(8, D2))
    X_all = (r.random((N2 + HELDOUT, D2)) < probs[r.integers(0, 8, N2 + HELDOUT)])
    x = torch.tensor(X_all[:N2], dtype=torch.float32, device=dev)
    xh = torch.tensor(X_all[N2:], dtype=torch.float32, device=dev)
    data = ((x, torch.ones(N2, device=dev)),)
    heldout = ((xh, torch.ones(HELDOUT, device=dev)),)
    log(f"config 2 data {N2}x{D2} binary + {HELDOUT} held out: {time.perf_counter() - t0:.2f} s")

    defn = st.model_definition(N2, [models.bbv(D2)], k_max=K2)
    hyper = {"alpha": np.ones(D2, np.float32), "beta": np.ones(D2, np.float32)}
    gen = rng(SEED + 3, dev).generator
    s0 = st.initialize(defn, data, gen, cluster_hp={"alpha": 1.0}, feature_hps=[hyper])
    bounds = {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (0.5, 50.0)}
    hp_kw = {"specs": {0: {"alpha": bounds, "beta": bounds}},
             "cluster": {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (1e-4, 1e4)}}
    run = runner(defn, data, s0, [("assign_blocked_fused", {}), ("slice_hp", hp_kw)])
    start = linear_at_start(s0, data, x, dev)

    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.run(gen, ITERS2)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launched = _launches()
    launches, updates = launched["fused_linear_assign"], launched["slice_update"]
    log(f"runner.run({ITERS2} x [fused bbv sweep, slice_hp]): {run_s:.3f} s, "
        f"{ITERS2 / run_s:.3f} iterations/s; launches {launched}")
    require(launches == ITERS2, f"linear kernel launches {launches} != {ITERS2} iterations")
    # alpha and beta of each column, then the concentration: one launch each
    require(updates == (2 * D2 + 1) * ITERS2 and sum(launched.values()) == launches + updates,
            f"slice_update launches {updates} != {(2 * D2 + 1) * ITERS2}, or another kernel ran: {launched}")
    scores = run.score_trace
    log(f"score_joint trace: {scores.tolist()}")
    log(f"k_active trace: {run.k_active_trace.tolist()}")
    require(np.isfinite(scores).all(), "non-finite score_joint")
    s = run.get_latent()
    require(int(s.counts.sum()) == N2, "counts do not sum to N")
    plain = blocked.restat(s, data, s.assignments)
    require(torch.equal(s.counts, plain.counts), "counts disagree with the plain restat")
    for leaf in ("n", "heads"):
        require(torch.equal(s.stats[0][leaf], plain.stats[0][leaf]),
                f"{leaf} disagrees with the plain restat")
    a, b = s.hypers[0]["alpha"], s.hypers[0]["beta"]
    log(f"hypers after {ITERS2} iterations: alpha in [{a.min():.3f}, {a.max():.3f}], "
        f"beta in [{b.min():.3f}, {b.max():.3f}], CRP alpha {float(s.cluster_hp['alpha']):.4f}")
    replayed = runner_replay("path B (config 2)", defn, data, s, [("assign_blocked_fused", {}), ("slice_hp", hp_kw)],
                             SEED + 302, dev)

    lp_dim = st.heldout_logp(s, heldout).mean().item() / D2
    one = st.initialize(defn, data, gen, cluster_hp={"alpha": 1.0}, feature_hps=[hyper],
                        assignment=np.zeros(N2, np.int32))
    lp_one = st.heldout_logp(one, heldout).mean().item() / D2
    log(f"held-out logp/dim ({HELDOUT} rows): {lp_dim:.5f}; one-cluster state {lp_one:.5f} "
        f"(the JAX record, after its own chain, was -0.404: history, not a matched comparison)")
    require(np.isfinite(lp_dim) and lp_dim > lp_one,
            "held-out logp does not beat the one-cluster state")

    # the pieces of one iteration, timed apart (median of 3)
    sweep_ms, hp_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = blocked.sweep_fused(s, data, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s = slice_.hp(s, data, gen, **hp_kw)
        torch.cuda.synchronize()
        sweep_ms.append(1e3 * (t1 - t0))
        hp_ms.append(1e3 * (time.perf_counter() - t1))
    sweep_med, hp_med = float(np.median(sweep_ms)), float(np.median(hp_ms))
    log(f"fused bbv sweep {sweep_med:.2f} ms, slice_hp {hp_med:.2f} ms "
        f"(share of the iteration {hp_med / (hp_med + sweep_med):.3f})")
    # kernel 5 against its plain version on one slice_hp of the run's final
    # state: each update's inputs (x0, level, seed, target) as the sampler
    # made them, one coordinate after another
    calls = []
    real = slice_.slice_update

    def recorded(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    slice_.slice_update = recorded
    try:
        slice_.hp(s, data, gen, **hp_kw)
    finally:
        slice_.slice_update = real
    kinds = [args[3].kind for args, _ in calls]
    require(kinds == [su.KIND_ALPHA] * D2 + [su.KIND_BETA] * D2 + [su.KIND_CRP],
            f"slice_hp made {len(calls)} kernel updates, not alpha and beta of {D2} columns and the concentration")
    plain5 = [su.slice_update_plain(*args) for args, _ in calls]
    mismatch5 = sum(int(not torch.equal(out, want)) for (_, out), want in zip(calls, plain5))
    require(mismatch5 == 0, f"slice_update: {mismatch5} of {len(calls)} updates differ from the plain version")

    def kernel5():
        for args, _ in calls:
            su.slice_update(*args)

    def plain_all5():
        for args, _ in calls:
            su.slice_update_plain(*args)

    k5 = cuda_ms(kernel5, 5) / len(calls)
    k5_dev = queued_ms(kernel5, 2) / len(calls)
    p5 = cuda_ms(plain_all5, 1) / len(calls)
    # bytes: counts, n and the column's heads once, x0, level, seed, the
    # other hyper and x1; the update is a chain of dependent evaluations, so
    # latency, not this bound, sets its time
    y5 = {**bound(0.0, 4.0 * (3 * K2 + 5)), "library": "none: no library call makes a slice update"}
    log(f"slice_update on path B's final state, {len(calls)} updates (K={K2}): equal to the plain version "
        f"bit for bit; kernel {k5:.4f} ms an update back to back, {k5_dev:.4f} ms on the card alone; plain "
        f"{p5:.4f} ms; bound {y5['bound_ms']:.2e} ms ({y5['bound_by']})")
    hp_idle, _ = profile_sweep(lambda: slice_.hp(s, data, gen, **hp_kw))

    # the kernel against its plain version, on this path's own inputs
    W, base, _ = blocked.linear_assign_inputs(s, data, gen)
    seed = _seed(9, dev)
    exact = require_exact(linear_exact_check(la.fused_linear_assign(x, W, base, seed),
                                             x, W, base, seed),
                          f"linear_assign on path B's inputs ({N2}x{D2}, K={K2}), draw for draw")
    t3 = linear_times(x, W, base, seed)
    k3, k3_dev, k3_cold = t3["ms"], t3["device_ms"], t3["ms_cold"]
    p3 = cuda_ms(lambda: la.linear_assign_plain(x, W, base, gen), 20)
    y3 = {**bound(2.0 * N2 * K2 * D2, 4.0 * (N2 * D2 + K2 * D2 + K2 + N2)),
          **{key: t3[key] for key in ("library_ms", "library_device_ms", "library_ms_cold")},
          "library": f"torch.addmm(base, X, W.T), X [{N2}, {D2}], W [{K2}, {D2}], fp32"}
    need = la.noise_work(x, W, base)
    log(f"linear_assign {N2}x{D2} K={K2}: kernel {k3:.4f} ms back to back, {k3_dev:.4f} ms on the "
        f"card alone, L2-cold {k3_cold:.4f} ms; plain {p3:.4f} ms; bound {y3['bound_ms']:.4f} ms "
        f"({y3['bound_by']}), share {y3['bound_ms'] / k3_dev:.3f} on the card alone "
        f"({y3['bound_ms'] / k3_cold:.3f} cold); library {y3['library']}: {y3['library_ms']:.4f} ms "
        f"back to back, {y3['library_device_ms']:.4f} ms on the card alone, L2-cold "
        f"{y3['library_ms_cold']:.4f} ms")
    log(f"  noise these inputs need, worked out in Python: {noise_line(need, K2)}")
    return {
        "kernels": [
            {"name": "linear_assign", "route": "cuda",
             "source": "common_tpu_torch/csrc/linear_assign.cu",
             "replaces": "common_tpu/ops/linear_assign.py:67",
             "launches": launches, "max_abs_err": exact["shortfall"],
             "mismatch": exact["mismatch"], "tie_rows": exact["ties"],
             "ms": k3, "device_ms": k3_dev, "ms_cold": k3_cold, "plain_ms": p3, **y3},
            {"name": "slice_update", "route": "cuda",
             "source": "common_tpu_torch/csrc/slice_update.cu",
             "replaces": "none: common_tpu/kernels/slice_.py:32 runs the update as a lax.while_loop",
             "launches": updates, "mismatch": mismatch5, "updates_checked": len(calls),
             "ms": k5, "device_ms": k5_dev, "plain_ms": p5, **y5},
        ],
        "linear_noise_need": need, "linear_at_start": start,
        "iterations_per_s": ITERS2 / run_s,
        "fused_sweep_ms": sweep_med, "slice_hp_ms": hp_med, "slice_hp_idle_share": hp_idle,
        "heldout_logp_per_dim": lp_dim, "one_cluster_logp_per_dim": lp_one, "replay": replayed,
    }


# ---------------------------------------------------------------------------
# phase 9: BASELINE config 3 (NUTS on the hypers) and SVI
# ---------------------------------------------------------------------------
def config3_rows(seed: int = SEED):
    """Config 3's rows, numpy seed `seed`: N9 + HELD9 rows of 8 planted
    clusters (bench.py:918-930 with numpy draws): a niw(DG9) column around
    centers at scale 4 with unit noise, a gp column with rates exp(N(0, 1)),
    a bb column with p ~ Beta(0.5, 0.5). Float32 arrays (xg, xp, xb); the
    last HELD9 rows are held out. `scripts/config3_reference.py` runs the
    JAX package on the same rows."""
    r = np.random.default_rng(seed)
    nh = N9 + HELD9
    z = r.integers(0, 8, nh)
    centers = 4.0 * r.normal(size=(8, DG9))
    xg = centers[z] + r.normal(size=(nh, DG9))
    rates = np.exp(r.normal(size=8))
    xp = r.poisson(rates[z])
    pb = r.beta(0.5, 0.5, size=8)
    xb = r.random(nh) < pb[z]
    return xg.astype(np.float32), xp.astype(np.float32), xb.astype(np.float32)


def config3_hypers():
    """The recipe's hypers (bench.py:932-941): niw (0, 1, I, DG9 + 2), gp (1, 1), bb (1, 1)."""
    return [{"mu0": np.zeros(DG9, np.float32), "kappa": 1.0,
             "psi": np.eye(DG9, dtype=np.float32), "nu": float(DG9 + 2)},
            {"alpha": 1.0, "inv_beta": 1.0}, {"alpha": 1.0, "beta": 1.0}]


def _float64(tree):
    """Numpy leaves (nested dicts and tuples) with every float array cast to
    float64, for the CPU references."""
    if isinstance(tree, dict):
        return {k: _float64(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_float64(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype.kind == "f":
        return tree.astype(np.float64)
    return tree


def phase_config3() -> dict:
    """Config 3 through the runner ([assign_blocked, nuts_hp, nuts_cluster_hp],
    bench.py:943-965), then SVI (CAVI and minibatch) on the same rows, and
    nuts_theta on a bbnc state over the binary column. Runs none of the four
    kernels, as the JAX recipe runs none of the Pallas kernels."""
    import torch

    from common_tpu_torch import convert, models, rng, scalar_functions as sf, state as st
    from common_tpu_torch.kernels import hmc, svi
    from common_tpu_torch.runner import KERNELS, runner

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cols = [torch.from_numpy(a).to(dev) for a in config3_rows()]
    ones, ones_h = torch.ones(N9, device=dev), torch.ones(HELD9, device=dev)
    data = tuple((c[:N9], ones) for c in cols)
    held = tuple((c[N9:], ones_h) for c in cols)
    defn = st.model_definition(N9, [models.niw(DG9), models.gp, models.bb], k_max=K9)
    hps = config3_hypers()
    gen = rng(SEED + 9, dev).generator
    s0 = st.initialize(defn, data, gen, cluster_hp={"alpha": 1.0}, feature_hps=hps)
    exp1 = sf.log_exponential(1.0)
    priors = {1: lambda h: exp1(h["alpha"]) + exp1(h["inv_beta"]),
              2: lambda h: exp1(h["alpha"]) + exp1(h["beta"])}
    config = [("assign_blocked", {}),
              ("nuts_hp", {"priors": priors, "num_steps": STEPS9, "max_depth": DEPTH9}),
              ("nuts_cluster_hp", {"prior": exp1, "num_steps": STEPS9, "max_depth": DEPTH9})]
    run = runner(defn, data, s0, config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.run(gen, 1)
    torch.cuda.synchronize()
    log(f"config 3 at {N9} x (niw{DG9}, gp, bb), K_max={K9}: set-up {t0 - t_phase:.2f} s, first "
        f"iteration {time.perf_counter() - t0:.2f} s")

    # the timed run; each NUTS transition's info is kept (the hyper target has 4
    # coordinates, alpha's 1), read after the run
    infos, nuts_step = [], hmc.nuts_step

    def recorded(logprob, q, *a, **kw):
        out = nuts_step(logprob, q, *a, **kw)
        infos.append((q.shape[0], out[2]))
        return out

    hmc.nuts_step = recorded
    try:
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run(gen, ITERS9)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        hmc.nuts_step = nuts_step
    launched = _launches()
    log(f"runner.run({ITERS9} x [assign_blocked, nuts_hp, nuts_cluster_hp]): {run_s:.3f} s, "
        f"{ITERS9 / run_s:.3f} iterations/s; kernel launches {launched}")
    require(not any(launched.values()), f"config 3 launched a hand-written kernel: {launched}")
    nuts = {}
    for kind, dim in (("nuts_hp", 4), ("nuts_cluster_hp", 1)):
        got = [i for d, i in infos if d == dim]
        require(len(got) == ITERS9 * STEPS9, f"{kind}: {len(got)} transitions for {ITERS9} x {STEPS9}")
        nuts[kind] = {
            "transitions": len(got),
            "leaves": float(np.mean([i.num_leaves - 1 for i in got])),
            "depth": float(np.mean([i.depth for i in got])),
            "accept": float(torch.stack([i.accept_prob for i in got]).mean()),
            "divergences": int(torch.stack([i.diverging for i in got]).sum()),
            "reads": float(np.mean([i.reads for i in got])),
        }
        log(f"{kind} per transition: {nuts[kind]['leaves']:.2f} new leaves, depth {nuts[kind]['depth']:.2f}, "
            f"acceptance {nuts[kind]['accept']:.3f}, {nuts[kind]['divergences']} divergences in "
            f"{len(got)}, {nuts[kind]['reads']:.2f} booleans read")

    s = run.get_latent()
    scores = run.score_trace
    log(f"score_joint trace: {scores.tolist()}")
    log(f"k_active trace: {run.k_active_trace.tolist()}")
    require(np.isfinite(scores).all(), "non-finite score_joint")
    hyp = {"alpha": float(s.cluster_hp["alpha"]),
           **{f"gp.{k}": float(v) for k, v in s.hypers[1].items()},
           **{f"bb.{k}": float(v) for k, v in s.hypers[2].items()}}
    log("hypers: " + ", ".join(f"{k} {v:.5f}" for k, v in hyp.items()))
    require(all(np.isfinite(v) and v > 0 for v in hyp.values()), f"a hyper left its support: {hyp}")
    require(int(s.counts.sum()) == N9, "counts do not sum to N")
    require_bookkeeping(s, data, "config-3 state", K9)
    replayed = runner_replay("config 3", defn, data, s, config, SEED + 305, dev)

    lp_row = st.heldout_logp(s, held).mean().item()
    one = st.initialize(defn, data, gen, cluster_hp={"alpha": 1.0}, feature_hps=hps,
                        assignment=np.zeros(N9, np.int32))
    lp_one = st.heldout_logp(one, held).mean().item()
    log(f"held-out logp/row ({HELD9} rows): {lp_row:.5f}; one-cluster state {lp_one:.5f}; the JAX "
        f"record -29.1028 (README.md:280) is a TPU run on other data: history, no bar")
    require(np.isfinite(lp_row) and lp_row > lp_one, "held-out logp does not beat the one-cluster state")

    # the hyper target's gradient: the card in fp32 against the CPU in float64
    s64 = convert.state_from_numpy(_float64(convert.state_to_numpy(s)), device="cpu")
    f32, q32, _, _ = hmc.hyper_logprob(s, priors)
    f64, q64, _, _ = hmc.hyper_logprob(s64, priors)
    v32, g32 = hmc.value_and_grad(f32)(q32)
    v64, g64 = hmc.value_and_grad(f64)(q64)
    gerr = (g32.double().cpu() - g64).abs().max().item() / g64.abs().max().item()
    log(f"nuts_hp target at the final state: value {v32.item():.6e} (fp32, card) vs {v64.item():.6e} "
        f"(float64, CPU); gradient {g64.tolist()}, max|g32 - g64| / max|g64| {gerr:.3e} (bar 1e-3)")
    require(gerr <= 1e-3, f"the card's hyper gradient is {gerr:.3e} off the float64 one")

    # each runner kernel's ms and share, over 3 iterations timed kernel by kernel
    ms = {name: 0.0 for name, _ in config}
    st_t = s
    for _ in range(3):
        for name, kw in config:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st_t = KERNELS[name](st_t, data, gen, **kw)
            torch.cuda.synchronize()
            ms[name] += 1e3 * (time.perf_counter() - t0) / 3
    total = sum(ms.values())
    log("one iteration by kernel: " + ", ".join(f"{k} {v:.2f} ms ({v / total:.3f})" for k, v in ms.items()))

    def iteration():
        st_i = s
        for name, kw in config:
            st_i = KERNELS[name](st_i, data, gen, **kw)

    idle, _ = profile_sweep(iteration)

    # the reads: one NUTS transition on the hyper target as shipped, against
    # 2^DEPTH9 - 1 leaves issued back to back with no read (what running every
    # leaf masked would cost at least)
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leaves = reads = 0
    for _ in range(reps):
        _, _, info = hmc.nuts_step(f32, q32, gen, 0.05, None, DEPTH9)
        leaves += info.num_leaves - 1
        reads += info.reads
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / reps
    vg = hmc.value_and_grad(f32)
    g0 = vg(q32)[1]
    unit = torch.ones_like(q32)

    def all_leaves():
        q, p, g = q32, torch.zeros_like(q32), g0
        for _ in range(2 ** DEPTH9 - 1):
            q, p, _, g = hmc._leaf(vg, q, p, g, 0.05, unit)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    all_leaves()
    torch.cuda.synchronize()
    masked_ms = 1e3 * (time.perf_counter() - t0)
    leaf_ms = masked_ms / (2 ** DEPTH9 - 1)
    log(f"nuts_hp transition as shipped: {step_ms:.2f} ms, {leaves / reps:.2f} new leaves and "
        f"{reads / reps:.2f} reads; {2 ** DEPTH9 - 1} leaves back to back with no read {masked_ms:.2f} ms "
        f"({leaf_ms:.3f} ms a leaf): the masked variant costs at least that a transition")

    # what one read of a device value costs the host, beside a launch alone
    one = torch.zeros((), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        one = one + 1.0
    torch.cuda.synchronize()
    launch_ms = 1e3 * (time.perf_counter() - t0) / 200
    t0 = time.perf_counter()
    for _ in range(200):
        bool(one + 1.0 > 0)
    read_ms = 1e3 * (time.perf_counter() - t0) / 200
    log(f"one launch issued: {launch_ms:.4f} ms; one launch and a read of its result: {read_ms:.4f} ms")

    # SVI on the same rows: init, CAVI (the first CHECK9 steps against float64 on the CPU), minibatch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = svi.init(defn, data, gen, cluster_hp={"alpha": 1.0}, feature_hps=hps)
    elbo0 = svi.elbo(post, data)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cavi, elbos = svi.fit_cavi(post, data, CAVI9)
    torch.cuda.synchronize()
    cavi_s = time.perf_counter() - t0
    trace = torch.cat([elbo0[None], elbos]).double().cpu().numpy()
    drop = float(np.min(np.diff(trace) / np.abs(trace[1:])))
    log(f"svi.init {init_s:.2f} s (ELBO {trace[0]:.6e}); fit_cavi({CAVI9}) {cavi_s:.2f} s, "
        f"{CAVI9 / cavi_s:.2f} iterations/s; ELBO {trace[1]:.6e} -> {trace[-1]:.6e}; smallest step "
        f"{drop:.3e} of |ELBO| (bar >= -1e-5)")
    require(np.isfinite(trace).all() and drop >= -1e-5, f"the CAVI ELBO fell by {-drop:.3e} of |ELBO|")

    t0 = time.perf_counter()
    post64 = convert.svi_from_numpy(_float64(convert.svi_to_numpy(post)), device="cpu")
    data64 = tuple((x.double().cpu(), m.double().cpu()) for x, m in data)
    cpu_post, _ = svi.fit_cavi(post64, data64, CHECK9)
    card_post, _ = svi.fit_cavi(post, data, CHECK9)
    require_replay(f"config 3: {CHECK9} CAVI steps", card_post, svi.fit_cavi(post, data, CHECK9)[0])
    # rtol 1e-3, with an atol of 1e-4 of each leaf's largest entry: each fp32
    # E-step moves r by a few 1e-6 of itself (its scores are tens of nats at
    # fp32 rounding), which moves a weighted sum by that share of the leaf's
    # size, and three steps compound it
    verr, worst = 0.0, ""
    for f, (a_f, b_f) in enumerate(zip(card_post.vstats, cpu_post.vstats)):
        for leaf, b in b_f.items():
            a = a_f[leaf].double().cpu()
            err = ((a - b).abs() - 1e-3 * b.abs()).max().item() / b.abs().max().item()
            rel = ((a - b).abs() / b.abs().clamp(min=1e-3 * b.abs().max().item())).max().item()
            if err >= verr:
                verr, worst = err, f"{f}.{leaf} (max |a - b| / max(|b|, 1e-3 max|b|) {rel:.3e})"
    log(f"first {CHECK9} CAVI steps, card fp32 vs CPU float64 from one posterior "
        f"({time.perf_counter() - t0:.2f} s): max over vstats of (|a - b| - 1e-3 |b|) / max|b| "
        f"{verr:.3e} at {worst} (bar <= 1e-4)")
    require(verr <= 1e-4, "the card's CAVI steps are off the float64 ones")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, _ = svi.fit_svi(post, data, gen, SVI9, BATCH9)
    torch.cuda.synchronize()
    svi_s = time.perf_counter() - t0
    elbo_svi = svi.elbo(fitted, data).item()
    log(f"fit_svi({SVI9} steps, batch {BATCH9}): {svi_s:.2f} s, {SVI9 / svi_s:.1f} steps/s; ELBO "
        f"{trace[0]:.6e} at init -> {elbo_svi:.6e}")
    require(np.isfinite(elbo_svi) and elbo_svi > trace[0], "SVI did not raise the ELBO above init's")
    hard = svi.to_state(fitted, data)
    lp_svi = st.heldout_logp(hard, held).mean().item()
    t0 = time.perf_counter()
    lp_pred = torch.stack([svi.predictive_logpdf(fitted, tuple((x[i], m[i]) for x, m in held))
                           for i in range(HELD9)]).mean().item()
    log(f"SVI held-out logp/row: {lp_svi:.5f} (to_state, heldout_logp), {lp_pred:.5f} "
        f"(predictive_logpdf, {time.perf_counter() - t0:.2f} s); k_active of to_state "
        f"{int((hard.counts > 0).sum())}")
    require(np.isfinite(lp_svi) and np.isfinite(lp_pred), "SVI's held-out logp is not finite")

    # nuts_theta on a bbnc state over the binary column, seated by config 3's
    # z, from one exact draw of p (gibbs.theta): at thousands of rows a slot,
    # p's posterior sd in logit space is about 0.01-0.2, so the step is 0.005
    # (the kernel's default 0.1 diverges on the first leaf from p = 0.5)
    bdefn, bdata = st.model_definition(N9, [models.bbnc], k_max=K9), (data[2],)
    sb = st.initialize(bdefn, bdata, gen, cluster_hp={"alpha": 1.0}, assignment=s.assignments)
    sb = KERNELS["theta"](sb, bdata, gen)
    trun = runner(bdefn, bdata, sb, [("nuts_theta", {"step_size": 0.005, "num_steps": STEPS9,
                                                     "max_depth": DEPTH9})])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trun.run(gen, THETA9)
    torch.cuda.synchronize()
    theta_s = time.perf_counter() - t0
    out_b = trun.get_latent()
    p, active = out_b.stats[0]["p"], out_b.counts > 0
    lo, hi = models.bbnc.likelihood.latent_bounds["p"]
    a_post = 1.0 + out_b.stats[0]["heads"]
    b_post = 1.0 + out_b.stats[0]["n"] - out_b.stats[0]["heads"]
    sd = torch.sqrt(a_post * b_post / ((a_post + b_post) ** 2 * (a_post + b_post + 1.0)))
    z_theta = ((p - a_post / (a_post + b_post)) / sd)[active]
    moved = int((p != sb.stats[0]["p"])[active].sum())
    log(f"nuts_theta x {THETA9} (step 0.005) on a bbnc state, {int(active.sum())} active slots: "
        f"{theta_s:.2f} s; {moved} slots moved off the exact draw; p within "
        f"{z_theta.abs().max().item():.2f} sd of its Beta conditional's mean (bar 6)")
    require(bool(torch.isfinite(p).all()) and bool(((p >= lo) & (p <= hi)).all()), "bbnc's p left its bounds")
    require(moved > 0 and z_theta.abs().max().item() <= 6.0, "nuts_theta did not sample bbnc's p")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 9 wall time {phase_s:.1f} s")
    return {"iterations_per_s": ITERS9 / run_s, "run_s": run_s, "kernel_ms": ms, "idle_share": idle,
            "nuts": nuts, "hypers": hyp, "heldout_logp_per_row": lp_row, "one_cluster_logp_per_row": lp_one,
            "hyper_grad_rel_err": gerr, "nuts_step_ms": step_ms, "masked_leaves_ms": masked_ms,
            "leaf_ms": leaf_ms, "launch_ms": launch_ms, "read_ms": read_ms, "cavi_iterations_per_s": CAVI9 / cavi_s, "cavi_elbo": trace.tolist(),
            "cavi_f64_err": verr, "svi_steps_per_s": SVI9 / svi_s, "svi_elbo": elbo_svi,
            "svi_heldout_logp_per_row": lp_svi, "svi_predictive_logp_per_row": lp_pred,
            "theta_s": theta_s, "theta_moved": moved, "replay": replayed, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 6: BASELINE config 1 by collapsed Gibbs
# ---------------------------------------------------------------------------
def phase_collapsed() -> dict:
    import os
    import tempfile

    import torch

    from common_tpu_torch import io, models, query, rng, scalar_functions as sf, state as st
    from common_tpu_torch.kernels import gibbs
    from common_tpu_torch.runner import runner

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    # examples/dpmm.py:21-23 at 10k rows
    r = np.random.default_rng(SEED)
    centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    z_true = r.integers(0, 3, N6)
    X = (centers[z_true] + r.normal(scale=0.6, size=(N6, 2))).astype(np.float32)
    data = ((torch.from_numpy(X).to(dev), torch.ones(N6, device=dev)),)
    defn = st.model_definition(N6, [models.niw(2)], k_max=K6)
    s0 = st.initialize(defn, data, rng(INIT6, dev).generator, cluster_hp={"alpha": 1.0})
    config = [("assign", {}), ("grid_cluster_hp", {"prior": sf.log_exponential(1.0),
                                                   "grid": np.geomspace(0.1, 10, 30)})]
    _zero_launches()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweeps.jsonl")
        run = runner(defn, data, s0, config, jsonl_path=path)
        gen = rng(GEN6, dev).generator
        sweep_s = []
        for _ in range(SWEEPS6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run.run(gen, 1)
            torch.cuda.synchronize()
            sweep_s.append(time.perf_counter() - t0)
        with open(path) as f:
            lines = [json.loads(x) for x in f.read().splitlines()]
    scores, k_active = run.score_trace, run.k_active_trace
    out = run.get_latent()
    log(f"runner.run x {SWEEPS6} ([assign, grid_cluster_hp]) at {N6}x2, K_max={K6}: "
        f"{[round(t, 2) for t in sweep_s]} s a sweep")
    log(f"score_joint trace: {scores.tolist()}")
    log(f"k_active trace: {k_active.tolist()}; alpha {float(out.cluster_hp['alpha']):.4f}")
    require(np.isfinite(scores).all(), "non-finite score_joint")
    require(len(lines) == SWEEPS6 and [x["sweep"] for x in lines] == list(range(SWEEPS6)),
            f"{len(lines)} JSONL lines for {SWEEPS6} sweeps")
    require([x["score_joint"] for x in lines] == scores.astype(np.float64).tolist(),
            "JSONL scores differ from the score trace")
    require(int(out.counts.sum()) == N6, "counts do not sum to N")
    launched = _launches()
    require(not any(launched.values()), f"the collapsed path launched a hand-written kernel: {launched}")

    zs = torch.from_numpy(run.assignment_trace[-LAST6:]).to(dev)
    co = torch.from_numpy(query.zmatrix(zs) > 0.5).to(dev)
    zt = torch.from_numpy(z_true).to(dev)
    agree = (co == (zt[:, None] == zt[None, :])).double().mean().item()
    log(f"co-assignment agreement with the planted labels, zmatrix of the last {LAST6} sweeps: "
        f"{agree:.5f} (bar > 0.95); k_active {int(k_active[-1])} (expect 3-5)")
    require(agree > 0.95, f"co-assignment agreement {agree} <= 0.95")

    # resume: 1 sweep, checkpoint with the generator, 1 more, against the
    # uninterrupted run's first 2 sweeps
    g = rng(GEN6, dev).generator
    first = runner(defn, data, s0, config)
    first.run(g, 1)
    blob = io.serialize(first.get_latent(), extra={"gen": g})
    restored, extra = io.deserialize(blob, device=dev)
    rest = runner(defn, data, restored, config)
    rest.run(extra["gen"], 1)
    same_z = np.array_equal(np.concatenate([first.assignment_trace, rest.assignment_trace]),
                            run.assignment_trace[:2])
    same_score = np.array_equal(np.concatenate([first.score_trace, rest.score_trace]),
                                scores[:2])
    log(f"resume after 1 sweep from a {len(blob)}-byte checkpoint: assignments "
        f"{'equal' if same_z else 'DIFFER'}, scores {'equal' if same_score else 'DIFFER'} "
        f"(bit for bit against the uninterrupted run)")
    require(same_z and same_score, "resumed run differs from the uninterrupted one")

    # one sweep under the sync check, timed: the rate
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        swept = gibbs.assign(out, data, gen)
        torch.cuda.synchronize()
        assign_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(int(swept.counts.sum()) == N6, "counts do not sum to N after the checked sweep")
    log(f"one gibbs.assign sweep under set_sync_debug_mode('error'): no host wait; "
        f"{assign_s:.2f} s, {N6 / assign_s:.1f} rows/s")

    # kernel launches per row and the idle share, on the first rows
    sub = tuple((x[:TRACE_ROWS6], m[:TRACE_ROWS6]) for x, m in data)
    s_sub = st.initialize(st.model_definition(TRACE_ROWS6, [models.niw(2)], k_max=K6), sub, gen,
                          cluster_hp={"alpha": float(out.cluster_hp["alpha"])},
                          assignment=out.assignments[:TRACE_ROWS6])
    idle, launched_n = profile_sweep(lambda: gibbs.assign(s_sub, sub, gen))
    per_row = launched_n / TRACE_ROWS6
    log(f"traced sweep of the first {TRACE_ROWS6} rows: {per_row:.1f} device kernels and copies "
        f"a row, idle share {idle:.3f}")
    anneal = _anneal(defn, data, z_true)
    phase_s = time.perf_counter() - t_phase
    log(f"phase 6 wall time {phase_s:.1f} s")
    return {"anneal": anneal, "rows_per_s": N6 / assign_s, "assign_sweep_s": assign_s,
            "runner_sweep_s": sweep_s, "agreement": agree, "k_active": int(k_active[-1]),
            "alpha": float(out.cluster_hp["alpha"]), "launches_per_row": per_row,
            "idle_share": idle, "checkpoint_bytes": len(blob), "phase_s": phase_s}


def _anneal(defn, data, z_true) -> dict:
    """Subsample annealing over config 1's rows from an empty state:
    linear_schedule(N6, add_per_step=ADD6, resample_per_step=RESAMPLE6)."""
    import torch

    from common_tpu_torch import rng
    from common_tpu_torch.kernels import annealing

    dev = torch.device("cuda")
    gen = rng(SEED + 6, dev).generator
    s0 = annealing.empty_state(defn, data, gen, cluster_hp={"alpha": 1.0})
    schedule = annealing.linear_schedule(N6, add_per_step=ADD6, resample_per_step=RESAMPLE6)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = annealing.run(s0, data, gen, *schedule)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    updates = schedule[0] * (ADD6 + RESAMPLE6)
    require(bool((s.assignments >= 0).all()), "annealing left a row unassigned")
    launched = _launches()
    require(not any(launched.values()), f"annealing launched a hand-written kernel: {launched}")
    require_bookkeeping(s, data, "annealed state", K6)
    z = s.assignments.long()
    zt = torch.from_numpy(z_true).to(dev)
    agree = ((z[:, None] == z[None, :]) == (zt[:, None] == zt[None, :])).double().mean().item()
    log(f"annealing.run({schedule}) at {N6}x2: {wall:.2f} s, {updates} row updates, {updates / wall:.1f} "
        f"updates/s, {N6 / wall:.1f} rows/s; every row active; co-assignment agreement with the planted "
        f"labels {agree:.5f} (no bar: one state after about two sweeps' updates); k_active "
        f"{int((s.counts > 0).sum())}")
    return {"wall_s": wall, "updates": updates, "updates_per_s": updates / wall, "rows_per_s": N6 / wall,
            "agreement": agree, "k_active": int((s.counts > 0).sum())}


# ---------------------------------------------------------------------------
# phase 10: BASELINE config 4, HDP-LDA
# ---------------------------------------------------------------------------
def hdp_corpus(dev, gen):
    """(a)'s corpus on the card (bench.py:1025-1042): doc d draws its L10 words
    uniformly from vocab block d % BLOCKS10; HELD10 of the positions held out."""
    import torch

    block = V10 // BLOCKS10
    words = (torch.arange(D10, device=dev) % BLOCKS10)[:, None] * block
    words = words + torch.randint(0, block, (D10, L10), generator=gen, device=dev)
    held = torch.rand((D10, L10), generator=gen, device=dev) < HELD10
    return words, (~held).float(), held


def require_recount(s, data, what: str) -> None:
    """The three count tables equal a recount from z, exactly."""
    import torch

    from common_tpu_torch.topic import hdp

    for name, got, want in zip(("doc_topic", "topic_word", "topic_total"),
                               (s.doc_topic, s.topic_word, s.topic_total),
                               hdp._counts(s.z, data, s.n_docs, s.n_topics, s.vocab_size)):
        require(torch.equal(got, want), f"{what}: {name} differs from a recount of z")


def _hdp_float64_gap(s) -> float:
    """|score_joint in fp32 - in float64 (both on the card)| / |float64|."""
    import dataclasses

    from common_tpu_torch import topic

    s64 = dataclasses.replace(
        s, beta=s.beta.double(), doc_topic=s.doc_topic.double(), topic_word=s.topic_word.double(),
        topic_total=s.topic_total.double(), hypers={k: v.double() for k, v in s.hypers.items()})
    a, b = topic.score_joint(s).item(), topic.score_joint(s64).item()
    return abs(a - b) / abs(b)


def _aten_assign_chunk(words, mask, z_old, log_theta, log_phi_t, generator):
    """The dense sweep's score-and-assign of one chunk of docs as the port ran
    it before `csrc/hdp_assign.cu`: about fifteen ATen launches over a [docs,
    L, K] float32 table (a yardstick of time only; its noise is the
    generator's, not the kernel's)."""
    import torch

    from common_tpu_torch.rng import uniform_open

    K = log_phi_t.shape[1]
    logp = log_phi_t[words]
    logp += log_theta[:, None, :]
    u = uniform_open(logp.shape, generator, logp.dtype)
    logp -= u.log_().neg_().log_()
    z = torch.where(mask > 0, torch.argmax(logp, dim=-1).to(torch.int32), z_old)
    dk = torch.zeros((words.shape[0], K + 1), dtype=torch.float32, device=words.device)
    dk.scatter_add_(1, torch.where(mask > 0, z.long(), K), torch.ones(words.shape, device=words.device))
    return z, dk


def _hdp_assign_check(s, words, mask, what: str) -> dict:
    """`ops.hdp_assign` on one chunk of CHUNK10 docs of state s at the cell's
    shapes: one launch under set_sync_debug_mode("error"), z and the doc
    counts equal to the plain version's bit for bit; the kernel's ms a chunk
    back to back and on the card alone, with and without the noise's
    pruning, the plain version's and the old ATen route's; the whole stage
    (`_assign_docs`: 50 launches and the topic-word count) a sweep."""
    import torch

    from common_tpu_torch import rng
    from common_tpu_torch.ops import hdp_assign as ha
    from common_tpu_torch.rng import device_seed
    from common_tpu_torch.topic import hdp

    dev = words.device
    g = rng(SEED + 308, dev).generator
    phi, theta = hdp._draw_phi_theta(s, g)
    log_phi_t = hdp._log_clipped(phi).t().contiguous()
    log_theta = hdp._log_clipped(theta)
    seed = device_seed(g, dev)
    a = 7 * CHUNK10  # a chunk past the first, so the noise's token index starts at a L
    b = a + CHUNK10
    args = (words[a:b], mask[a:b], s.z.view(D10, L10)[a:b], log_theta[a:b], log_phi_t, seed)
    torch.cuda.synchronize()
    before = ha.hdp_assign.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        z, dk = ha.hdp_assign(*args, doc0=a)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(ha.hdp_assign.launches == before + 1, f"{what}: hdp_assign launched {ha.hdp_assign.launches - before}")
    want_z, want_dk = ha.hdp_assign_plain(*args, doc0=a)
    mismatch = int((z != want_z).sum())
    require(mismatch == 0 and torch.equal(dk, want_dk),
            f"{what}: hdp_assign differs from the plain version ({mismatch} tokens)")
    require(torch.equal(dk.sum(-1), args[1].sum(-1)), f"{what}: a doc's counts do not sum to its tokens")
    ms = cuda_ms(lambda: ha.hdp_assign(*args, doc0=a), 20)
    device_ms = queued_ms(lambda: ha.hdp_assign(*args, doc0=a), 20)
    plain_ms = cuda_ms(lambda: ha.hdp_assign_plain(*args, doc0=a), 3)
    aten_ms = cuda_ms(lambda: _aten_assign_chunk(*args[:5], g), 5)
    stage_ms = cuda_ms(lambda: hdp._assign_docs(s, words, mask, phi, theta, g, CHUNK10), 3)
    chunks = D10 // CHUNK10
    log(f"hdp_assign {what}, one chunk of {CHUNK10} docs x {L10} tokens (K={K10}): equal to the plain version "
        f"bit for bit under set_sync_debug_mode('error'); kernel {ms:.4f} ms back to back, {device_ms:.4f} on "
        f"the card alone ({chunks * device_ms:.3f} ms a sweep against the stage's once-counted 0.2712); plain "
        f"{plain_ms:.3f} ms; the old ATen route {aten_ms:.3f} ms; _assign_docs a sweep ({chunks} launches + the "
        f"topic-word count) {stage_ms:.3f} ms")
    return {"mismatch": mismatch, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "aten_ms": aten_ms,
            "stage_ms": stage_ms}


def _hdp_chain(dev) -> dict:
    """(a): the record's chain, 18 dense sweeps + the CRT beta draw; the dense route through the runner
    once, against the same sweep bit for bit; then (b), the runner's flat
    route on its end."""
    import torch

    from common_tpu_torch import rng, topic
    from common_tpu_torch.runner import HDP_FAMILY, HDP_KERNELS, make_step, runner
    from common_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    gen = rng(SEED + 10, dev).generator
    words, mask, held = hdp_corpus(dev, gen)
    data = topic.dense_token_data(words, mask)
    s0 = topic.initialize(data, K10, V10, gen, n_docs=D10)
    idx = torch.nonzero(held.reshape(-1)).flatten()
    held_td = topic.TokenData(words.reshape(-1)[idx], idx // L10, torch.ones(idx.shape[0], device=dev))
    score0, ppl0 = topic.score_joint(s0).item(), topic.perplexity(s0, held_td).item()
    log(f"config 4 corpus {D10} docs x {L10} tokens, V={V10}, {BLOCKS10} blocks, K={K10}, "
        f"{idx.shape[0]} held-out positions: set-up {time.perf_counter() - t_phase:.2f} s; "
        f"initial score_joint {score0:.6e}, held-out perplexity {ppl0:.2f}")

    def chain(s, n):
        scores = []
        for _ in range(n):
            s = topic.blocked_sweep_dense(s, words, mask, gen, doc_chunk=CHUNK10)
            s = topic.sample_beta(s, gen, max_count=L10)
            scores.append(topic.score_joint(s))
        return s, torch.stack(scores)

    assign_start = _hdp_assign_check(s0, words, mask, "at the random start")
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    s, scores = chain(s0, SWEEPS10)
    peak = profiling.device_memory_stats()["allocated_bytes.all.peak"]
    log(f"blocked_sweep_dense(doc_chunk={CHUNK10}) + sample_beta(max_count={L10}) + score_joint x "
        f"{SWEEPS10}: peak memory {peak / 2**30:.2f} GiB")
    launched = _launches()
    want_launches = SWEEPS10 * (D10 // CHUNK10)
    require(launched["hdp_assign"] == want_launches == sum(launched.values()),
            f"config 4 launches {launched}: not hdp_assign {want_launches} times alone")
    assign_end = _hdp_assign_check(s, words, mask, "after 18 sweeps")

    require_recount(s, data, "after 18 sweeps")
    require(torch.equal(s.doc_topic.sum(-1), mask.sum(-1)), "a doc_topic row does not sum to its doc's tokens")
    beta_sum = s.beta.sum().item()
    require(bool((s.beta > 0).all()) and abs(beta_sum - 1.0) <= 1e-5, f"beta off the simplex: sum {beta_sum}")
    require(torch.equal(s.z.view(D10, L10)[held], s0.z.view(D10, L10)[held]), "a held-out position's z moved")
    score, gap, slot = topic.score_joint(s).item(), _hdp_float64_gap(s), s.topic_total.max().item()
    trace = scores.tolist()
    log(f"score_joint over 18 sweeps: {trace[0]:.6e} -> {score:.6e} (initial {score0:.6e}); fp32 vs "
        f"float64 on the card: relative gap {gap:.3e}; largest count slot {slot:.0f} (float32 exact to "
        f"{2 ** 24}); active topics {int(s.active_topics())}")
    require(np.isfinite(score) and score > score0, "score_joint did not rise above the initial state's")
    require(slot < 2 ** 24, "a count slot passed float32's exact range")
    ppl = topic.perplexity(s, held_td).item()
    log(f"held-out per-token perplexity after 18 sweeps: {ppl:.2f} (bar < 5000; uniform {V10}, planted "
        f"floor {V10 // BLOCKS10}; the JAX record {JAX_PPL10} on a TPU, history)")
    require(np.isfinite(ppl) and ppl < 5000, f"held-out perplexity {ppl} not under 5000")

    def dense_pair():
        g, x = rng(SEED + 306, dev).generator, s
        for _ in range(2):
            x = topic.sample_beta(topic.blocked_sweep_dense(x, words, mask, g, doc_chunk=CHUNK10), g, max_count=L10)
        return x

    replayed = replay("config 4: 2 dense sweeps + sample_beta", dense_pair)

    # the dense route on the runner's normal path: one step under
    # set_sync_debug_mode("error"), equal to the sweep + beta draw it wraps
    dense_config = [("assign_blocked_dense", {"doc_chunk": CHUNK10}), ("beta", {})]
    t0 = time.perf_counter()
    dense_step = make_step(dense_config, data, HDP_FAMILY)
    build_s = time.perf_counter() - t0
    g_run, g_ref = rng(SEED + 307, dev).generator, rng(SEED + 307, dev).generator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d_state = dense_step(s, g_run)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = topic.sample_beta(topic.blocked_sweep_dense(s, words, mask, g_ref, doc_chunk=CHUNK10), g_ref,
                             max_count=HDP_FAMILY["default_kw"](data)["max_count"])
    require(_hdp_same(d_state, want), "the runner's assign_blocked_dense + beta differs from "
            "blocked_sweep_dense + sample_beta")
    require_recount(d_state, data, "runner dense step")
    log(f"runner [assign_blocked_dense(doc_chunk={CHUNK10}), beta]: make_step {build_s:.2f} s (the corpus's "
        f"doc length found on the host), one step under set_sync_debug_mode('error'): no host wait; equal to "
        f"blocked_sweep_dense + sample_beta bit for bit")
    chain_rec = {"peak_gib": peak / 2**30, "score_joint": score,
                 "score_f64_rel_gap": gap, "largest_slot": slot, "active_topics": int(s.active_topics()),
                 "perplexity": ppl, "perplexity_init": ppl0, "score_trace": trace, "replay": replayed,
                 "runner_dense_equal": True, "launches": launched, "hdp_assign_start": assign_start,
                 "hdp_assign_end": assign_end}

    # (b) the runner's HDP family on the same corpus, from (a)'s end
    config = [("assign_blocked", {}), ("concentrations", {})]
    flat = data  # the dense corpus's flat view: the runner's sweep is the flat blocked_sweep
    _zero_launches()
    t0 = time.perf_counter()
    run = runner(None, flat, s, config)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r_state = run.run(gen, RUNNER10, collect=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    r_peak = profiling.device_memory_stats()["allocated_bytes.all.peak"]
    step = make_step(config, flat, HDP_FAMILY)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r_state = step(r_state, gen)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    kw = HDP_FAMILY["default_kw"](flat)
    blocked_ms = cuda_ms(lambda: HDP_KERNELS["assign_blocked"](r_state, flat, gen, **kw), 2)
    conc_ms = cuda_ms(lambda: HDP_KERNELS["concentrations"](r_state, flat, gen, **kw), 2)
    alpha, gamma = r_state.hypers["alpha"].item(), r_state.hypers["gamma"].item()
    require(np.isfinite(alpha) and np.isfinite(gamma) and alpha > 0 and gamma > 0,
            f"concentrations not finite and positive: alpha {alpha}, gamma {gamma}")
    require_recount(r_state, flat, "runner")
    launched = _launches()
    require(not any(launched.values()), f"the HDP runner launched a hand-written kernel: {launched}")
    log(f"runner [assign_blocked, concentrations] on the flat corpus: built in {build_s:.2f} s (max_count "
        f"{kw['max_count']} from the host), {RUNNER10} iterations {run_s:.2f} s "
        f"({1e3 * run_s / RUNNER10:.1f} ms an iteration with the score trace; assign_blocked {blocked_ms:.1f}, "
        f"concentrations {conc_ms:.1f}); peak memory of the unchunked [T, K] sweep {r_peak / 2**30:.2f} GiB; "
        f"one more step under set_sync_debug_mode('error'): no host wait; alpha {alpha:.4f}, gamma {gamma:.4f}")
    runner_rec = {"iteration_ms": 1e3 * run_s / RUNNER10, "assign_blocked_ms": blocked_ms,
                  "concentrations_ms": conc_ms, "peak_gib": r_peak / 2**30, "alpha": alpha, "gamma": gamma}
    return {"chain": chain_rec, "runner": runner_rec, "words": words, "mask": mask}


def _hdp_collapsed(dev) -> dict:
    """(c): examples/lda_topics.py's corpus through [assign, concentrations],
    a checkpoint-resume pair, a few more sweeps."""
    import os
    import tempfile

    import torch

    from common_tpu_torch import io, rng, topic
    from common_tpu_torch.data import variadic_dataview
    from common_tpu_torch.runner import runner

    r = np.random.default_rng(1)
    rows = [r.choice(np.arange((d % 3) * 10, (d % 3 + 1) * 10), size=LEN10C) for d in range(DOCS10C)]
    view = variadic_dataview(rows, device=dev)
    data = topic.token_data(view)
    s0 = topic.initialize(view, K10C, V10C, rng(SEED + 11, dev).generator, eta=0.1)
    ppl0 = topic.perplexity(s0, data).item()
    config = [("assign", {}), ("concentrations", {})]
    _zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweeps.jsonl")
        run = runner(None, data, s0, config, jsonl_path=path)
        gen = rng(SEED + 12, dev).generator
        sweep_s = []
        for _ in range(2 + MORE10C):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run.run(gen, 1)
            torch.cuda.synchronize()
            sweep_s.append(time.perf_counter() - t0)
        with open(path) as f:
            lines = [json.loads(x) for x in f.read().splitlines()]
    out = run.get_latent()
    require(len(lines) == 2 + MORE10C and [x["score_joint"] for x in lines] == run.score_trace.astype(
        np.float64).tolist(), "JSONL lines differ from the score trace")
    require(np.isfinite(run.score_trace).all(), "non-finite score_joint")
    require_recount(out, data, "collapsed chain")
    launched = _launches()
    require(not any(launched.values()), f"the collapsed HDP path launched a hand-written kernel: {launched}")

    g = rng(SEED + 12, dev).generator
    first = runner(None, data, s0, config)
    first.run(g, 1)
    blob = io.serialize(first.get_latent(), extra={"gen": g})
    restored, extra = io.deserialize(blob, device=dev)
    rest = runner(None, data, restored, config)
    rest.run(extra["gen"], 1)
    same_z = np.array_equal(np.concatenate([first.assignment_trace, rest.assignment_trace]),
                            run.assignment_trace[:2])
    same_score = np.array_equal(np.concatenate([first.score_trace, rest.score_trace]), run.score_trace[:2])
    log(f"collapsed HDP resume after 1 sweep from a {len(blob)}-byte checkpoint: z "
        f"{'equal' if same_z else 'DIFFER'}, scores {'equal' if same_score else 'DIFFER'} (bit for bit)")
    require(same_z and same_score, "the resumed collapsed HDP run differs from the uninterrupted one")

    sub_view = variadic_dataview(rows[:TRACE_DOCS10C], device=dev)
    sub = topic.token_data(sub_view)
    s_sub = topic.initialize(sub_view, K10C, V10C, gen, eta=0.1)
    idle, launched_n = profile_sweep(lambda: topic.collapsed_sweep(s_sub, sub, gen))
    per_token = launched_n / (TRACE_DOCS10C * LEN10C)
    ppl = topic.perplexity(out, data).item()
    log(f"collapsed runner x {2 + MORE10C} on {DOCS10C} x {LEN10C} tokens, V={V10C}, K={K10C}: "
        f"{[round(t, 3) for t in sweep_s]} s a sweep; perplexity {ppl0:.3f} -> {ppl:.3f}; active topics "
        f"{int(out.active_topics())}; traced sweep of {TRACE_DOCS10C} docs: {per_token:.1f} device kernels "
        f"and copies a token, idle share {idle:.3f}")
    require(ppl < ppl0, "the collapsed chain did not lower the perplexity")
    return {"sweep_s": sweep_s, "perplexity_init": ppl0, "perplexity": ppl, "launches_per_token": per_token,
            "idle_share": idle, "checkpoint_bytes": len(blob)}


def _online_lda(dev, words, mask) -> dict:
    """(d): CAVI and minibatch SVI on the first LDA10 docs of (a)'s corpus."""
    import torch

    from common_tpu_torch import rng, topic
    from common_tpu_torch.topic import svi as lda

    t0 = time.perf_counter()
    n = LDA10 + HELD_LDA10
    counts_all = lda.doc_term_matrix(topic.dense_token_data(words[:n], mask[:n]), V10, n_docs=n)
    counts, held = counts_all[:LDA10], counts_all[LDA10:]
    gen = rng(SEED + 13, dev).generator
    post0 = lda.init(K10, V10, gen, alpha=0.5, eta=0.1)
    torch.cuda.synchronize()
    log(f"online LDA: [{LDA10} x {V10}] f32 counts ({counts.numel() * 4 / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post, bounds = lda.fit_cavi(post0, counts, CAVI10)
    bounds = bounds.tolist()
    cavi_s = time.perf_counter() - t0
    worst = min((b - a) / abs(a) for a, b in zip(bounds[:-1], bounds[1:]))
    log(f"fit_cavi x {CAVI10}: {cavi_s:.2f} s, {CAVI10 / cavi_s:.3f} iterations/s; bound {bounds[0]:.6e} -> "
        f"{bounds[-1]:.6e}, smallest step {worst:.3e} of itself (bar >= -1e-5)")
    require(all(np.isfinite(bounds)) and worst >= -1e-5, "the CAVI bound fell")

    c_dev = counts[:CHECK_DOCS10]
    lam_card = lda.step(post0, c_dev, CHECK_DOCS10, 1.0).lam.cpu().double()
    post64 = lda.LDAPosterior(post0.lam.cpu().double(), post0.alpha.cpu().double(), post0.eta.cpu().double())
    lam_cpu = lda.step(post64, c_dev.cpu().double(), CHECK_DOCS10, 1.0).lam
    rel = ((lam_card - lam_cpu).abs() / lam_cpu.abs()).max().item()
    log(f"first CAVI step on {CHECK_DOCS10} docs, card fp32 vs CPU float64 from one posterior: max relative "
        f"error of lam {rel:.3e} (bar 1e-4)")
    require(rel <= 1e-4, "the card's CAVI step is off the float64 one")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted = lda.fit_svi(post0, counts, gen, SVI10, BATCH10, tau0=64.0, kappa=0.7)
    torch.cuda.synchronize()
    svi_s = time.perf_counter() - t0
    p_init, p_svi, p_cavi = (lda.perplexity(p, held).item() for p in (post0, fitted, post))
    log(f"fit_svi x {SVI10} at batch {BATCH10} (tau0 64, kappa 0.7): {svi_s:.2f} s, {SVI10 / svi_s:.2f} "
        f"steps/s; held-out perplexity on docs {LDA10}-{n - 1}: init {p_init:.2f}, SVI {p_svi:.2f}, "
        f"CAVI {p_cavi:.2f}")
    require(np.isfinite(p_svi) and p_svi < p_init, "SVI did not lower the held-out perplexity")
    return {"cavi_iterations_per_s": CAVI10 / cavi_s, "cavi_bounds": bounds, "cavi_f64_rel_err": rel,
            "svi_steps_per_s": SVI10 / svi_s, "perplexity_init": p_init, "perplexity_svi": p_svi,
            "perplexity_cavi": p_cavi}


def phase_hdp(dev=None) -> dict:
    """Config 4 (HDP-LDA) at the JAX record's recipe, its runner family, the
    collapsed sampler with a resume, and online LDA. The dense sweep
    launches `csrc/hdp_assign.cu`; the other routes run no kernel."""
    import torch

    dev = torch.device("cuda") if dev is None else dev
    t_phase = time.perf_counter()
    rec = _hdp_chain(dev)
    words, mask = rec.pop("words"), rec.pop("mask")
    rec["collapsed"] = _hdp_collapsed(dev)
    rec["lda"] = _online_lda(dev, words, mask)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10 wall time {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 11: the IRM
# ---------------------------------------------------------------------------
def irm_blocks(n: int, blocks: int, seed: int):
    """A planted n x n Beta-Bernoulli relation from numpy `seed`: blocks x
    blocks equal blocks, 0.85 on the diagonal and 0.1 off it, three
    off-diagonal blocks at 0.6 (as tests/test_irm.py:183-188 at 60 x 60).
    Returns the relation and the planted labels of its rows (and columns)."""
    r = np.random.default_rng(seed)
    eta = np.full((blocks, blocks), 0.1)
    np.fill_diagonal(eta, 0.85)
    off = [(i, j) for i in range(blocks) for j in range(blocks) if i != j]
    for k in r.choice(len(off), 3, replace=False):
        eta[off[k]] = 0.6
    z = np.repeat(np.arange(blocks), n // blocks)
    return (r.random((n, n)) < eta[z][:, z]).astype(np.float32), z


def agreement(z, zt) -> float:
    """Co-assignment agreement of one assignment with the planted labels (on the card)."""
    return ((z[:, None] == z[None, :]) == (zt[:, None] == zt[None, :])).double().mean().item()


def require_irm_bookkeeping(s, views, what: str) -> None:
    """Counts sum to N_d; each relation's n stats sum to its observed cells;
    counts and stats equal a rebuild from the assignments (bb's stats hold
    integers, exact in float32 to 2^24)."""
    import torch

    from common_tpu_torch.relational import kernels as irm_kernels

    rebuilt = irm_kernels.restat(s, views)
    for d, (z, c) in enumerate(zip(s.assignments, s.counts)):
        require(int(c.sum()) == z.shape[-1], f"{what}: domain {d}'s counts do not sum to N_d")
        require(torch.equal(c, rebuilt.counts[d]), f"{what}: domain {d}'s counts are not a count of z")
    for r, view in enumerate(views):
        cells, n = int(view.mask.sum().item()), s.suffstats[r]["n"].double().sum().item()
        require(n == cells, f"{what}: relation {r}'s n stats sum to {n}, not its {cells} cells")
        for k, v in s.suffstats[r].items():
            require(torch.equal(v, rebuilt.suffstats[r][k]), f"{what}: relation {r}'s {k} differs from a rebuild")
    log(f"{what}: counts sum to N_d; n stats sum to the observed cells; counts and stats equal a rebuild")


def _irm_full_width(dev) -> dict:
    """(a): the runner's blocked sweep on the N11 x N11 relation, FULL_CHAINS11 starts."""
    import torch

    from common_tpu_torch import models, rng
    from common_tpu_torch import relational as irm
    from common_tpu_torch.data import sparse_ndarray_dataview
    from common_tpu_torch.kernels.blocked import stick_break_log_weights
    from common_tpu_torch.relational import kernels as irm_kernels
    from common_tpu_torch.rng import gumbel_argmax
    from common_tpu_torch.runner import make_step, IRM_FAMILY, runner

    t0 = time.perf_counter()
    rel, z_np = irm_blocks(N11, BLOCKS11, SEED)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device=dev)])
    zt = torch.from_numpy(z_np).to(dev)
    cells = views[0].indices.shape[0]
    defn = irm.model_definition([N11, N11], [((0, 1), models.bb)], k_max=K11)
    torch.cuda.synchronize()
    log(f"IRM relation {N11} x {N11} ({cells} cells, {int(rel.sum())} ones), {BLOCKS11} x {BLOCKS11} planted "
        f"blocks, K_max={K11} in both domains: set-up {time.perf_counter() - t0:.2f} s")
    config = [("assign_blocked", {})]
    _zero_launches()
    chains = []
    for c in range(FULL_CHAINS11):
        r = np.random.default_rng(SEED + 1 + c)
        start = [r.integers(0, K11, N11).astype(np.int32) for _ in range(2)]
        s0 = irm.initialize(defn, views, rng(SEED + 20 + c, dev).generator, cluster_hps=[{"alpha": 1.0}] * 2,
                            domain_assignments=start)
        gen = rng(SEED + 60 + c, dev).generator
        run = runner(defn, views, s0, config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run(gen, 1)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run.run(gen, SWEEPS11 - 1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        out = run.get_latent()
        chains.append({"score": float(run.score_trace[-1]), "agreement": [agreement(z, zt) for z in out.assignments],
                       "k": [int(out.ngroups(d)) for d in range(2)], "first_s": first_s,
                       "sweeps_per_s": (SWEEPS11 - 1) / run_s, "peak": torch.cuda.max_memory_allocated(),
                       "run": run})
        x = chains[-1]
        log(f"chain {c}: runner [assign_blocked] x {SWEEPS11}, first sweep {first_s:.3f} s, then "
            f"{x['sweeps_per_s']:.3f} sweeps/s; score_joint {x['score']:.6e}; agreement rows "
            f"{x['agreement'][0]:.5f}, columns {x['agreement'][1]:.5f}; clusters {x['k']}")
    best = max(chains, key=lambda x: x["score"])
    run, s = best["run"], best["run"].get_latent()
    rates = [x["sweeps_per_s"] for x in chains]
    scores = run.score_trace
    agree = best["agreement"]
    above = sum(min(x["agreement"]) > 0.95 for x in chains)
    log(f"{np.median(rates):.3f} sweeps/s (median of {FULL_CHAINS11} chains, {min(rates):.3f}-{max(rates):.3f}), "
        f"{np.median(rates) * cells:.4e} cells/s (the JAX record 0.90 sweeps/s, 1.51e7 cells/s on a TPU, "
        f"history); peak memory {max(x['peak'] for x in chains) / 2**30:.2f} GiB")
    log(f"the best-scoring chain's score_joint trace: {scores.tolist()}")
    log(f"its k_active (both domains) {run.k_active_trace.tolist()}; co-assignment agreement with the planted "
        f"labels, rows {agree[0]:.5f}, columns {agree[1]:.5f} (bar > 0.95; the JAX record 0.988 on a TPU, "
        f"history); {above} of {FULL_CHAINS11} chains above the bar in both domains")
    require(all(np.isfinite(x["run"].score_trace).all() for x in chains), "non-finite IRM score_joint")
    require(min(agree) > 0.95, f"IRM co-assignment agreement {agree} not above 0.95")
    launched = _launches()
    require(not any(launched.values()), f"the IRM launched a hand-written kernel: {launched}")
    require_irm_bookkeeping(s, views, f"after {SWEEPS11} blocked sweeps")

    # one runner step under the sync check
    step = make_step(config, views, IRM_FAMILY)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(s, gen)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # replay: each domain's table built twice, 3 blocked sweeps twice, the runner's resume pair
    thetas = irm_kernels._sample_block_params(s, gen)
    tables = [irm_kernels._domain_loglik_table(s, views, thetas, d) for d in range(2)]
    again = [irm_kernels._domain_loglik_table(s, views, thetas, d) for d in range(2)]
    differ = [int((a != b).sum()) for a, b in zip(tables, again)]
    log(f"each domain's table built twice from one state and theta: {differ[0]} and {differ[1]} of "
        f"{tables[0].numel()} entries differ (an atomic index_add_ route: about 127k of domain 0's, "
        f"scripts/irm_determinism.py)")
    require(all(torch.equal(a, b) for a, b in zip(tables, again)), f"the IRM tables differ run to run: {differ}")
    del again

    def blocked3():
        g, x = rng(SEED + 307, dev).generator, s
        for _ in range(3):
            x = irm_kernels.sweep(x, views, g)
        return x

    replayed = {"tables_differ": differ, "blocked": replay("IRM: 3 blocked sweeps", blocked3),
                "runner": runner_replay("IRM [assign_blocked]", defn, views, s, config, SEED + 308, dev)}
    # where a sweep's time goes
    logw = [stick_break_log_weights(gen, s.counts[d], s.cluster_hps[d]["alpha"]) for d in range(2)]
    sweep_ms = cuda_ms(lambda: irm_kernels.sweep(s, views, gen), 3)
    theta_ms = cuda_ms(lambda: irm_kernels._sample_block_params(s, gen), 3)
    table_ms = [cuda_ms(lambda d=d: irm_kernels._domain_loglik_table(s, views, thetas, d), 3) for d in range(2)]
    argmax_ms = [cuda_ms(lambda d=d: gumbel_argmax(logw[d][None, :] + tables[d], gen), 3) for d in range(2)]
    restat_ms = cuda_ms(lambda: irm_kernels.restat(s, views), 3)
    log(f"ms: blocked sweep {sweep_ms:.2f} = theta draw {theta_ms:.3f} + row table {table_ms[0]:.2f} + row "
        f"argmax {argmax_ms[0]:.3f} + column table {table_ms[1]:.2f} + column argmax {argmax_ms[1]:.3f} + restat "
        f"{restat_ms:.2f} (+ the rest {sweep_ms - theta_ms - sum(table_ms) - sum(argmax_ms) - restat_ms:.2f}); "
        f"one runner step under set_sync_debug_mode('error'): no host wait")
    idle, n_ops = profile_sweep(lambda: irm_kernels.sweep(s, views, gen))

    # the same recipe from a CRP start, for the record (no bar)
    s_crp = irm.initialize(defn, views, rng(SEED + 22, dev).generator, cluster_hps=[{"alpha": 1.0}] * 2)
    run_crp = runner(defn, views, s_crp, config)
    run_crp.run(gen, SWEEPS11)
    agree_crp = [agreement(z, zt) for z in run_crp.get_latent().assignments]
    log(f"the same {SWEEPS11} sweeps from a CRP start (no bar): agreement rows {agree_crp[0]:.5f}, columns "
        f"{agree_crp[1]:.5f}; k_active {run_crp.k_active_trace.tolist()}")
    return {"cells": cells, "sweeps_per_s": float(np.median(rates)), "sweeps_per_s_chains": rates,
            "cells_per_s": float(np.median(rates)) * cells, "first_sweep_s": [x["first_s"] for x in chains],
            "peak_gib": max(x["peak"] for x in chains) / 2**30, "agreement": agree,
            "agreement_chains": [x["agreement"] for x in chains], "chains_above_bar": above,
            "agreement_crp_start": agree_crp, "score_trace": scores.tolist(), "sweep_ms": sweep_ms,
            "theta_ms": theta_ms, "table_ms": table_ms, "argmax_ms": argmax_ms, "restat_ms": restat_ms,
            "idle_share": idle, "device_ops": n_ops, "replay": replayed}


def _irm_self_relation(dev) -> dict:
    """(b), second part: blocked sweeps on a SELF11 x SELF11 self-relation,
    the sequential-given-theta path."""
    import torch

    from common_tpu_torch import models, rng
    from common_tpu_torch import relational as irm
    from common_tpu_torch.data import sparse_ndarray_dataview
    from common_tpu_torch.relational import kernels as irm_kernels

    rel, z_np = irm_blocks(SELF11, BLOCKS11, SEED + 2)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device=dev)])
    defn = irm.model_definition([SELF11], [((0, 0), models.bb)], k_max=K11)
    start = np.random.default_rng(SEED + 3).integers(0, K11, SELF11).astype(np.int32)
    s = irm.initialize(defn, views, rng(SEED + 23, dev).generator, cluster_hps=[{"alpha": 1.0}],
                       domain_assignments=[start])
    gen = rng(SEED + 24, dev).generator
    s = irm_kernels.sweep(s, views, gen)  # builds the per-entity cell index
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SELF_SWEEPS11 - 1):
        s = irm_kernels.sweep(s, views, gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (SELF_SWEEPS11 - 1)
    agree = agreement(s.assignments[0], torch.from_numpy(z_np).to(dev))
    require(np.isfinite(irm.score_joint(s).item()), "non-finite score_joint on the self-relation")
    require_irm_bookkeeping(s, views, f"self-relation after {SELF_SWEEPS11} blocked sweeps")
    log(f"blocked sweep of a {SELF11} x {SELF11} self-relation ({BLOCKS11} planted blocks, sequential given "
        f"theta): {ms:.1f} ms a sweep; agreement after {SELF_SWEEPS11} sweeps {agree:.5f} (no bar); "
        f"k_active {int(s.ngroups(0))}")
    return {"sweep_ms": ms, "agreement": agree}


def _irm_nich(dev) -> dict:
    """(d): replay on a NICH11 x NICH11 nich relation (float suffstats, which
    bb's integer counts would hide), 10% of its cells missing: 3 blocked
    sweeps twice, and one collapsed sweep of the first LINK_N11 rows' domain
    (a LINK_N11 x NICH11 cut of it) twice."""
    import torch

    from common_tpu_torch import models, rng
    from common_tpu_torch import relational as irm
    from common_tpu_torch.data import sparse_ndarray_dataview
    from common_tpu_torch.relational import kernels as irm_kernels

    r = np.random.default_rng(SEED)
    z = np.repeat(np.arange(BLOCKS11), NICH11 // BLOCKS11)
    means = r.normal(0.0, 2.0, (BLOCKS11, BLOCKS11))
    rel = (means[z][:, z] + r.normal(size=(NICH11, NICH11))).astype(np.float32)
    missing = r.random((NICH11, NICH11)) < 0.1
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, missing_mask=missing, device=dev)])
    defn = irm.model_definition([NICH11, NICH11], [((0, 1), models.nich)], k_max=K11)
    start = [r.integers(0, K11, NICH11).astype(np.int32) for _ in range(2)]
    s0 = irm.initialize(defn, views, rng(SEED + 25, dev).generator, cluster_hps=[{"alpha": 1.0}] * 2,
                        domain_assignments=start)

    def blocked3():
        g, x = rng(SEED + 26, dev).generator, s0
        for _ in range(3):
            x = irm_kernels.sweep(x, views, g)
        return x

    blocked = replay(f"IRM nich {NICH11} x {NICH11}, 10% missing: 3 blocked sweeps", blocked3)
    s = blocked3()
    require(np.isfinite(irm.score_joint(s).item()), "non-finite score_joint on the nich relation")
    require_irm_bookkeeping(s, views, "nich relation after 3 blocked sweeps")

    cut = irm.as_views([sparse_ndarray_dataview(dense=rel[:LINK_N11], missing_mask=missing[:LINK_N11],
                                                device=dev)])
    cdefn = irm.model_definition([LINK_N11, NICH11], [((0, 1), models.nich)], k_max=K11)
    sc = irm.initialize(cdefn, cut, rng(SEED + 27, dev).generator, cluster_hps=[{"alpha": 1.0}] * 2,
                        domain_assignments=[start[0][:LINK_N11], s.assignments[1].cpu().numpy()])
    irm_kernels.assign(sc, cut, rng(SEED + 28, dev).generator)  # builds the per-entity cell index
    collapsed = replay(f"IRM nich {LINK_N11} x {NICH11}: one collapsed sweep of {LINK_N11} entities",
                       lambda: irm_kernels.assign(sc, cut, rng(SEED + 28, dev).generator))
    sweep_ms = cuda_ms(lambda: irm_kernels.sweep(s, views, rng(SEED + 29, dev).generator), 3)
    collapsed_ms = cuda_ms(lambda: irm_kernels.assign(sc, cut, rng(SEED + 29, dev).generator), 2)
    log(f"nich: blocked sweep {sweep_ms:.2f} ms at {NICH11} x {NICH11}; collapsed sweep of {LINK_N11} "
        f"entities {collapsed_ms:.1f} ms")
    return {"blocked": blocked, "collapsed": collapsed, "sweep_ms": sweep_ms, "collapsed_ms": collapsed_ms}


def _irm_links(dev) -> dict:
    """(b): examples/irm_links.py's recipe from LINK_CHAINS11 starts; then
    (c): a checkpoint round trip of the collapsed runner's state."""
    import torch

    from common_tpu_torch import io, models, rng
    from common_tpu_torch import relational as irm
    from common_tpu_torch.data import sparse_ndarray_dataview
    from common_tpu_torch.relational import kernels as irm_kernels
    from common_tpu_torch.runner import runner

    n = LINK_N11
    r = np.random.default_rng(3)  # examples/irm_links.py
    z_true = np.repeat(np.arange(3), n // 3)
    probs = np.where(z_true[:, None] == z_true[None, :], 0.9, 0.1)
    rel = (r.random((n, n)) < probs).astype(np.float32)
    missing = r.random((n, n)) < 0.15
    defn = irm.model_definition([n], [((0, 0), models.bb)], k_max=8)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, missing_mask=missing, device=dev)])
    held = np.argwhere(missing)
    truth = probs[held[:, 0], held[:, 1]] > 0.5
    config = [("assign", {}), ("ew_domain_alpha", {})]
    _zero_launches()
    chains = []
    for c in range(LINK_CHAINS11):
        s0 = irm.initialize(defn, views, rng(SEED + 30 + c, dev).generator, cluster_hps=[{"alpha": 1.0}])
        run = runner(defn, views, s0, config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run.run(rng(SEED + 130 + c, dev).generator, LINK_ITERS11)
        torch.cuda.synchronize()
        p = irm.predict_missing(out, 0, held, (0.0, 1.0))
        acc = float(((p[:, 1] > 0.5).cpu().numpy() == truth).mean())
        chains.append({"score": float(run.score_trace[-1]), "accuracy": acc, "groups": int(out.ngroups(0)),
                       "s": time.perf_counter() - t0, "start": s0, "state": out})
    best = max(chains, key=lambda x: x["score"])
    log(f"examples/irm_links.py ({n} x {n}, {len(held)} held-out cells), [assign, ew_domain_alpha] x "
        f"{LINK_ITERS11} from {LINK_CHAINS11} CRP starts: accuracy "
        f"{[round(x['accuracy'], 4) for x in chains]}, groups {[x['groups'] for x in chains]}, "
        f"{[round(x['s'], 2) for x in chains]} s a chain; the best-scoring chain: accuracy {best['accuracy']:.4f} "
        f"(bar >= {LINK_BAR11}; the JAX example's CPU run 1.000)")
    require(best["accuracy"] >= LINK_BAR11, f"held-out link accuracy {best['accuracy']} under {LINK_BAR11}")
    require_irm_bookkeeping(best["state"], views, "links")
    launched = _launches()
    require(not any(launched.values()), f"the collapsed IRM launched a hand-written kernel: {launched}")

    gen = rng(SEED + 40, dev).generator
    s = best["state"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        irm_kernels.assign(s, views, gen)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    idle, n_ops = profile_sweep(lambda: irm_kernels.assign(s, views, gen))
    log(f"one collapsed sweep under set_sync_debug_mode('error'): no host wait, {1e3 * sweep_s:.1f} ms, "
        f"{n_ops / n:.1f} device kernels and copies an entity, idle share {idle:.3f}")

    # (c) resume: 1 iteration, a checkpoint with the generator, 1 more, against 2 straight
    s0 = best["start"]
    g = rng(SEED + 41, dev).generator
    straight = runner(defn, views, s0, config)
    straight.run(g, 2)
    g = rng(SEED + 41, dev).generator
    first = runner(defn, views, s0, config)
    first.run(g, 1)
    blob = io.serialize(first.get_latent(), extra={"gen": g})
    restored, extra = io.deserialize(blob, device=dev)
    rest = runner(defn, views, restored, config)
    last = rest.run(extra["gen"], 1)
    same = (np.array_equal(np.concatenate([first.assignment_trace, rest.assignment_trace]),
                           straight.assignment_trace)
            and np.array_equal(np.concatenate([first.score_trace, rest.score_trace]), straight.score_trace)
            and torch.equal(last.cluster_hps[0]["alpha"], straight.get_latent().cluster_hps[0]["alpha"]))
    log(f"collapsed IRM resume after 1 iteration from a {len(blob)}-byte checkpoint: assignments, scores "
        f"and alpha {'equal' if same else 'DIFFER'} (bit for bit against 2 straight)")
    require(same, "the resumed collapsed IRM run differs from the uninterrupted one")
    return {"accuracy": [x["accuracy"] for x in chains], "best_accuracy": best["accuracy"],
            "groups": [x["groups"] for x in chains], "chain_s": [x["s"] for x in chains],
            "collapsed_sweep_ms": 1e3 * sweep_s, "launches_per_entity": n_ops / n, "idle_share": idle,
            "checkpoint_bytes": len(blob)}


def phase_irm(dev=None) -> dict:
    """The IRM (BASELINE's IRM family): the blocked sweep at the JAX record's
    width, a self-relation, link prediction and a resume. Runs none of the
    four kernels, as the JAX package's relational/ runs none of the Pallas kernels."""
    import torch

    dev = torch.device("cuda") if dev is None else dev
    t_phase = time.perf_counter()
    rec = {"full_width": _irm_full_width(dev), "self_relation": _irm_self_relation(dev),
           "links": _irm_links(dev), "nich": _irm_nich(dev)}
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11 wall time {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 12: the (chains x data) mesh, the sharded sweep, sharded block-SMC,
# the scaling harness and the CSV loader
# ---------------------------------------------------------------------------
def _same_state(a, b) -> bool:
    """Assignments, counts and every stats leaf equal bit for bit."""
    import torch

    return (torch.equal(a.assignments, b.assignments) and torch.equal(a.counts, b.counts)
            and all(torch.equal(x[k], y[k]) for x, y in zip(a.stats, b.stats) for k in x))


def _sharded_sweep_check(mesh, world: int, headline, what: str) -> dict:
    """One chain per chain row over the mesh's shards of the main path's
    rows, N // world rows a rank: the first sweep's kernel-1
    draw against its plain scores plus the noise of its global rows, then
    SWEEPS12 timed sweeps; the all-reduced counts and stats and the next
    sweep's theta bit-identical across the data ranks; the gathered chain's
    bookkeeping against a plain restat on all rows."""
    import torch
    import torch.distributed as dist

    from common_tpu_torch import models, state as st
    from common_tpu_torch.kernels import blocked
    from common_tpu_torch.parallel import mesh as mesh_mod
    from common_tpu_torch.parallel import sharded, stack_states, unstack_state
    from common_tpu_torch.rng import device_seed

    (x, mask), = headline["data"]
    n = (N // world) * mesh.data  # every rank holds N // world rows
    data = ((x[:n], mask[:n]),)
    defn = st.model_definition(n, [models.niw(D)], k_max=K_MAX)
    gen0 = torch.Generator(device=mesh.device).manual_seed(SEED + 12 + mesh.chain_index)
    s0 = st.initialize(defn, data, gen0, cluster_hp={"alpha": 1.0}, feature_hps=[headline["hyper"]])
    # the mesh's chain stack, where this rank's chain is its own start (the others it never keeps)
    states, local = mesh_mod.shard_state(mesh, stack_states([s0] * mesh.chains), data)
    del s0
    sweep = sharded.make_sharded_sweep(mesh, states, local)
    gens = sharded.chain_generators(mesh, SEED + 120, mesh.chains)
    r0 = mesh.data_index * local[0][0].shape[0]

    # the first sweep's own kernel inputs, from a copy of the chain's generator
    probe = torch.Generator(device=mesh.device)
    probe.set_state(gens[0].get_state())
    mu, binv, base, _ = blocked.fused_assign_inputs(unstack_state(states, 0), local, probe)
    seed = device_seed(probe, mesh.device)
    _zero_launches()
    states = sweep(states, local, gens)
    launched = _launches()
    check = require_exact(assign_exact_check(states.assignments[0], local[0][0], mu, binv, base, seed, row0=r0),
                          f"{what}: kernel 1 on rows {r0}..{r0 + local[0][0].shape[0]} with row_offset {r0}")
    require(launched["fused_gaussian_assign"] == 1 and launched["fused_scatter_stats"] == 1,
            f"{what}: launches {launched} in one sweep of one chain")

    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SWEEPS12):
        states = sweep(states, local, gens)
    torch.cuda.synchronize()
    dist.barrier()
    sweep_s = (time.perf_counter() - t0) / SWEEPS12

    # after 1 + SWEEPS12 all_reduces: the reduced counts and stats, and the next
    # sweep's theta drawn from them by each rank's own generator, bit-identical
    # across the chain's data ranks (the no-broadcast design rests on this)
    s = unstack_state(states, 0)
    reduced = torch.cat([s.counts.reshape(-1).to(torch.float32)] + [v.reshape(-1) for v in s.stats[0].values()])
    reduced_all = mesh_mod.all_gather_cat(reduced[None], mesh.data_group)
    same_stats = bool(torch.equal(reduced_all, reduced_all[:1].expand_as(reduced_all)))
    require(same_stats, f"{what}: the all-reduced counts and stats differ across the data ranks")
    probe.set_state(gens[0].get_state())
    mu, binv, base, _ = blocked.fused_assign_inputs(s, local, probe)
    theta = torch.cat([mu.reshape(-1), binv.reshape(-1), base.reshape(-1)])
    theta_all = mesh_mod.all_gather_cat(theta[None], mesh.data_group)
    same_theta = bool(torch.equal(theta_all, theta_all[:1].expand_as(theta_all)))
    require(same_theta, f"{what}: theta after {1 + SWEEPS12} sweeps differs across the data ranks")
    del reduced, reduced_all, theta, theta_all, mu, binv, base

    # the collective alone: the chain's counts and stats, as the sweep reduces them
    payload = [s.counts] + list(s.stats[0].values())
    ar = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_mod.all_reduce_sum(payload, mesh.data_group)
        torch.cuda.synchronize()
        ar.append(1e3 * (time.perf_counter() - t0))
    nbytes = sum(t.numel() * t.element_size() for t in payload)
    full = sharded.gather_chain(mesh, states, 0)
    errs = require_bookkeeping(full, data, f"{what}: chain {mesh.chain_index} gathered", K_MAX)
    return {"sweep_ms": 1e3 * sweep_s, "sweeps_per_s": 1.0 / sweep_s, "all_reduce_ms": float(np.median(ar)),
            "all_reduce_bytes": nbytes, "kernel1_check": check, "theta_identical": same_theta,
            "stats_identical": same_stats,
            "stats_err": errs, "rows_a_rank": local[0][0].shape[0], "launches_one_sweep": launched}


def _sharded_smc_check(mesh, headline, joint: float) -> dict:
    """run_blocked_sharded at phase 7's settings on the first N12 rows."""
    import torch

    from common_tpu_torch import models, state as st
    from common_tpu_torch.kernels import smc
    from common_tpu_torch.parallel import mesh as mesh_mod, unstack_state
    from common_tpu_torch.parallel.chains import map_tensors

    (x, mask), = headline["data"]
    data = ((x[:N12], mask[:N12]),)
    defn = st.model_definition(N12, [models.niw(D)], k_max=K_MAX)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 127)
    parts = smc.init_particles(defn, data, gen, P7, cluster_hp={"alpha": 1.0}, feature_hps=[headline["hyper"]])
    parts, sdata = smc.shard_particles(mesh, parts, data)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = smc.run_blocked_sharded(mesh, parts, sdata, gen, block=BLOCK7, warmup=WARMUP7, rejuvenation_blocks=REJUV7)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launches()
    p = res.particles
    require(p.counts.sum(-1).tolist() == [N12] * p.counts.shape[0], "sharded SMC: a particle does not seat every row")
    top = int(torch.argmax(res.log_w))
    errs = require_bookkeeping(unstack_state(p, top), data, f"sharded SMC rank {mesh.rank} top particle", K_MAX)
    logz = float(res.logz)
    require(np.isfinite(logz) and logz >= joint - SLACK7 * abs(joint), f"sharded SMC: logz {logz} below {joint}")
    # one resample's particle exchange alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    map_tensors(lambda t: mesh_mod.all_gather_cat(t, mesh.data_group), p)
    torch.cuda.synchronize()
    gather_ms = 1e3 * (time.perf_counter() - t0)
    return {"wall_s": wall, "rows_per_s": N12 / wall, "logz": logz, "n_resamples": res.n_resamples,
            "steps": len(res.ess_trace), "launches": launched, "stats_err": errs,
            "particle_gather_ms": gather_ms}


def _phase12_rank(rank, world, store, out, backend, joint):
    """A rank of (b)/(c): a (1 x W) and a (W x 1) mesh over the main path's
    rows, then (b) also block-SMC's particles sharded over the W ranks."""
    import torch
    import torch.distributed as dist

    from common_tpu_torch.parallel import mesh as mesh_mod
    from common_tpu_torch.kernels import smc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    if rank:  # rank 0 speaks for the ranks; a failure on any rank raises in the parent
        sys.stdout = open(os.devnull, "w")
    mesh_mod.init_distributed(backend, init_method=f"file://{store}", world_size=world, rank=rank)
    torch.cuda.set_device(torch.device(device))
    headline = headline_data()
    rec = {}
    for shape in ((1, world), (world, 1)):
        mesh = mesh_mod.make_mesh(*shape, backend=backend, device=device if backend == "gloo" else None)
        rec[f"{shape[0]}x{shape[1]}"] = _sharded_sweep_check(mesh, world, headline,
                                                             f"{backend} {shape[0]}x{shape[1]} rank {rank}")
    if backend == "gloo":
        rec["smc"] = _sharded_smc_check(smc.make_particle_mesh(backend, device=device), headline, joint)
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def _spawn_ranks(world: int, backend: str, joint: float, tmp: str) -> list:
    from common_tpu_torch.parallel import mesh as mesh_mod

    out = os.path.join(tmp, f"p12_{backend}")
    mesh_mod.spawn(_phase12_rank, (world, os.path.join(tmp, f"store_{backend}"), out, backend, joint), world,
                   timeout_s=SPAWN_TIMEOUT12)
    recs = []
    for r in range(world):
        with open(f"{out}.{r}.json") as f:
            recs.append(json.load(f))
    return recs


def phase_sharded(main_path: dict) -> dict:
    """Phase 12: the mesh layer on the card (see the module docstring)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from common_tpu_torch import models, rng, state as st
    from common_tpu_torch.io import loader
    from common_tpu_torch.kernels import blocked, smc
    from common_tpu_torch.ops import gaussian_assign as ga
    from common_tpu_torch.parallel import mesh as mesh_mod
    from common_tpu_torch.parallel import measure_row_scaling, sharded, stack_states, unstack_state

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p12_")
    rec = {}
    headline = headline_data()
    data, hyper = headline["data"], headline["hyper"]
    x, mask = data[0]
    dev = torch.device("cuda")

    # (a) world size 1 over NCCL, the main path's rows
    mesh_mod.init_distributed("nccl", init_method=f"file://{tmp}/store_a", world_size=1, rank=0)
    mesh = mesh_mod.make_mesh(1, 1, backend="nccl")
    defn = st.model_definition(N, [models.niw(D)], k_max=K_MAX)
    s0 = st.initialize(defn, data, rng(SEED + 12, dev).generator, cluster_hp={"alpha": 1.0}, feature_hps=[hyper])
    states, local = mesh_mod.shard_state(mesh, stack_states([s0]), data)
    sweep = sharded.make_sharded_sweep(mesh, states, local)
    g_sh, g_one = rng(SEED + 120, dev).generator, rng(SEED + 120, dev).generator
    _zero_launches()
    torch.cuda.synchronize()
    for _ in range(3):
        states = sweep(states, local, [g_sh])
    torch.cuda.synchronize()
    launched = _launches()
    one = s0
    for _ in range(3):
        one = blocked.sweep_fused(one, data, g_one)
    equal = _same_state(unstack_state(states, 0), one)
    log(f"(a) nccl, world size 1, {N}x{D}, K_max={K_MAX}: 3 sharded sweeps equal 3 sweep_fused sweeps bit for bit: "
        f"{equal}; launches {launched}")
    require(equal, "world size 1: the sharded sweep differs from sweep_fused")
    require(launched["fused_gaussian_assign"] == 3 and launched["fused_scatter_stats"] == 3
            and sum(launched.values()) == 6, f"world size 1: launches {launched} != 3 of kernels 1 and 2")
    rec["launches_ws1"] = launched
    # kernel 1 over two row shards with their offsets against one launch over all rows
    mu, binv, base, _ = blocked.fused_assign_inputs(one, data, rng(SEED + 121, dev).generator)
    seed = torch.tensor([12], dtype=torch.int32, device=dev)
    whole = ga.fused_gaussian_assign(x, mu, binv, base, seed)
    half = N // 2
    shards = torch.cat([ga.fused_gaussian_assign(x[:half], mu, binv, base, seed),
                        ga.fused_gaussian_assign(x[half:], mu, binv, base, seed, row_offset=half)])
    check = assign_exact_check(shards, x, mu, binv, base, seed, keep_tie=True)
    tie = check.pop("tie_mask")
    require_exact(check, "(a) kernel 1, two row shards")
    differ = int((shards != whole).sum())
    differ_out = int((shards != whole)[~tie].sum())
    log(f"(a) kernel 1 over rows [0, {half}) and [{half}, {N}) with row_offset {half}: {differ} rows differ "
        f"from one launch over all rows, {differ_out} of them outside the fp32 tie band ({check['ties']} tie rows)")
    require(differ_out == 0, "kernel 1's row shards differ from one launch outside the tie band")
    rec["shards_vs_whole_rows_differ"] = differ
    del tie
    times = {"sweep_fused": [], "sharded": []}
    for name in ("sweep_fused", "sharded", "sharded", "sweep_fused"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SWEEPS12):
            if name == "sharded":
                states = sweep(states, local, [g_sh])
            else:
                one = blocked.sweep_fused(one, data, g_one)
        torch.cuda.synchronize()
        times[name].append(1e3 * (time.perf_counter() - t0) / SWEEPS12)
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    leaves = [one.counts] + list(one.stats[0].values())
    ar_ms = cuda_ms(lambda: mesh_mod.all_reduce_sum(leaves, mesh.data_group), 5)
    log(f"(a) in turns, {SWEEPS12} sweeps each: sweep_fused {ms['sweep_fused']:.2f} ms, sharded {ms['sharded']:.2f} ms "
        f"a sweep ({1e3 / ms['sharded']:.3f} sweeps/s; phase 3's runner {main_path['sweeps_per_s']:.3f} sweeps/s, "
        f"its fused sweep {main_path['fused_sweep_ms']:.2f} ms); the all_reduce of counts and stats "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e6:.1f} MB) alone {ar_ms:.3f} ms")
    rec["ws1"] = {"sharded_sweep_ms": ms["sharded"], "sweep_fused_ms": ms["sweep_fused"],
                  "sweeps_per_s": 1e3 / ms["sharded"], "phase3_sweeps_per_s": main_path["sweeps_per_s"],
                  "all_reduce_ms": ar_ms}
    del states, local, one, s0, shards, whole

    # (d), world size 1: run_blocked_sharded equals run_blocked; the joint bound of a blocked chain on the rows
    rows = ((x[:N12], mask[:N12]),)
    defn12 = st.model_definition(N12, [models.niw(D)], k_max=K_MAX)
    chain = st.initialize(defn12, rows, rng(SEED + 122, dev).generator, cluster_hp={"alpha": 1.0}, feature_hps=[hyper])
    g = rng(SEED + 123, dev).generator
    joints = []
    for _ in range(JOINT_SWEEPS12):
        chain = blocked.sweep_fused(chain, rows, g)
        joints.append(float(st.score_joint(chain)))
    joint = max(joints)
    smc_mesh = smc.make_particle_mesh("nccl")
    parts = smc.init_particles(defn12, rows, rng(SEED + 127, dev).generator, P7, cluster_hp={"alpha": 1.0},
                               feature_hps=[hyper])
    local_p, sdata = smc.shard_particles(smc_mesh, parts, rows)
    kw = dict(block=BLOCK7, warmup=WARMUP7, rejuvenation_blocks=REJUV7)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = smc.run_blocked_sharded(smc_mesh, local_p, sdata, rng(SEED + 128, dev).generator, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launches()
    b = smc.run_blocked(parts, rows, rng(SEED + 128, dev).generator, **kw)
    same = (torch.equal(a.logz, b.logz) and torch.equal(a.log_w, b.log_w)
            and torch.equal(a.particles.assignments, b.particles.assignments) and a.n_resamples == b.n_resamples)
    n_blocks = -(-(N12 - WARMUP7) // BLOCK7)
    log(f"(d) nccl, world size 1, block-SMC P={P7}, block {BLOCK7}, warmup {WARMUP7} on the first {N12} of the "
        f"main path's rows (cut from {N} for time): run_blocked_sharded equals run_blocked bit for bit: {same}; "
        f"{wall:.2f} s, {N12 / wall:.1f} rows/s, {a.n_resamples} resamples, logz {float(a.logz):.6e}; best joint of "
        f"{JOINT_SWEEPS12} blocked sweeps {joint:.6e}; launches {launched}")
    require(same, "world size 1: run_blocked_sharded differs from run_blocked")
    require(launched["fused_scatter_stats"] == n_blocks * (1 + 2 * REJUV7) and sum(launched.values())
            == launched["fused_scatter_stats"], f"sharded SMC launches {launched}")
    rec["smc_ws1"] = {"wall_s": wall, "rows_per_s": N12 / wall, "logz": float(a.logz),
                      "n_resamples": a.n_resamples, "best_joint": joint, "launches": launched}
    del parts, local_p, a, b, chain
    dist.destroy_process_group()
    del headline, data, x, mask, rows, sdata
    torch.cuda.empty_cache()

    # (b) two ranks sharing the one card over gloo (host-staged collectives: a plumbing number)
    t0 = time.perf_counter()
    recs = _spawn_ranks(2, "gloo", joint, tmp)
    log(f"(b) gloo, two processes on one card: {time.perf_counter() - t0:.1f} s with the spawn and each rank's data")
    for shape in ("1x2", "2x1"):
        r = recs[0][shape]
        log(f"(b) {shape}: {r['rows_a_rank']} rows a rank, {r['sweeps_per_s']:.3f} sweeps/s ({r['sweep_ms']:.1f} ms "
            f"a sweep; two processes on one card over gloo, not a multi-card rate); the all_reduce of "
            f"{r['all_reduce_bytes'] / 1e6:.1f} MB {r['all_reduce_ms']:.1f} ms; after "
            f"{1 + SWEEPS12} sweeps, stats and theta identical across data ranks {r['stats_identical']} "
            f"{r['theta_identical']}")
    sm = [q["smc"] for q in recs]
    log(f"(d) gloo, two processes on one card: run_blocked_sharded, {P7 // 2} particles a rank: "
        f"{sm[0]['wall_s']:.2f} s, {sm[0]['rows_per_s']:.1f} rows/s, {sm[0]['n_resamples']} resamples of "
        f"{sm[0]['steps']} steps, logz {sm[0]['logz']:.6e} (bar >= {joint:.6e} - {SLACK7} x |joint|); one "
        f"resample's particle all_gather {sm[0]['particle_gather_ms']:.1f} ms; kernel 2 launches a rank "
        f"{[q['launches']['fused_scatter_stats'] for q in sm]}")
    require(sm[0]["logz"] == sm[1]["logz"], "sharded SMC: the ranks' logz differ")
    rec["gloo_2"] = recs

    # (c) several cards over NCCL
    count = torch.cuda.device_count()
    if count >= 2:
        world = min(count, 4)
        t0 = time.perf_counter()
        rec["nccl_cards"] = _spawn_ranks(world, "nccl", joint, tmp)
        for shape in (f"1x{world}", f"{world}x1"):
            r = rec["nccl_cards"][0][shape]
            log(f"(c) nccl over {world} cards, {shape}: {r['sweeps_per_s']:.3f} sweeps/s, all_reduce "
                f"{r['all_reduce_ms']:.2f} ms")
        log(f"(c) {time.perf_counter() - t0:.1f} s")
    else:
        log(f"(c) one card found (torch.cuda.device_count() = {count}): no multi-card NCCL run")

    # (e) the scaling harness, two ranks on one card: a plumbing check
    t0 = time.perf_counter()
    scaling = measure_row_scaling(shard_counts=(1, 2), devices=["cuda:0", "cuda:0"], backend="gloo",
                                  timeout_s=SPAWN_TIMEOUT12)
    log(f"(e) measure_row_scaling(shard_counts=(1, 2)) at {scaling['n']} x {scaling['d']}, K_max {scaling['k_max']}, "
        f"one card shared over gloo (a plumbing check, not a scaling claim): throughput {scaling['throughput']} "
        f"sweeps/s, spread {scaling['spread']}, efficiency {scaling['efficiency']:.3f}, collectives_ok "
        f"{scaling['collectives_ok']} ({time.perf_counter() - t0:.1f} s)")
    require(scaling["collectives_ok"], "the scaling harness's collectives failed")
    rec["scaling"] = {**scaling, "throughput": {str(k): v for k, v in scaling["throughput"].items()},
                      "spread": {str(k): v for k, v in scaling["spread"].items()}}

    # (f) the CSV loader, on the host of the card's machine
    r = np.random.default_rng(SEED)
    rows_np = r.standard_normal((CSV_ROWS12, CSV_COLS12)).astype(np.float32)
    path = os.path.join(tmp, "rows.csv")
    np.savetxt(path, rows_np, fmt="%.7g", delimiter=",")
    mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    loader.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = loader.load_csv_f32_native(path)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = loader.load_csv_f32_plain(path)
    plain_s = time.perf_counter() - t0
    equal = bool(np.array_equal(native, plain)) and native.shape == rows_np.shape
    log(f"(f) load_csv_f32 of {CSV_ROWS12} x {CSV_COLS12} ({mb:.1f} MB): native {CSV_ROWS12 / native_s:.0f} rows/s, "
        f"{mb / native_s:.1f} MB/s; numpy {CSV_ROWS12 / plain_s:.0f} rows/s, {mb / plain_s:.1f} MB/s; equal "
        f"{equal}; g++ build {build_s:.2f} s")
    require(equal, "the native CSV parse differs from numpy's")
    rec["loader"] = {"native_rows_per_s": CSV_ROWS12 / native_s, "native_mb_per_s": mb / native_s,
                     "numpy_rows_per_s": CSV_ROWS12 / plain_s, "numpy_mb_per_s": mb / plain_s, "mb": mb,
                     "build_s": build_s}
    shutil.rmtree(tmp)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12 wall time {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 13: the sharded HDP and IRM sweeps
# ---------------------------------------------------------------------------
def _hdp_same(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("z", "doc_topic", "topic_word", "topic_total", "beta"))


def _irm_same(a, b) -> bool:
    import torch

    return (all(torch.equal(x, y) for x, y in zip(a.assignments + a.counts, b.assignments + b.counts))
            and all(torch.equal(x[k], y[k]) for x, y in zip(a.suffstats, b.suffstats) for k in x))


def _in_turns(what: str, start, sharded_step, one_step, same) -> dict:
    """sharded, one-device, one-device, sharded, after one untimed step of
    each: SWEEPS13 steps a turn from `start`, each turn with a generator of
    one seed; every turn's end equal bit for bit, ms a step of each side."""
    import torch

    from common_tpu_torch import rng

    ends, ms = {}, {"sharded": [], "one": []}
    for step in (sharded_step, one_step):  # one untimed step each: allocations, the first collective
        step(start, rng(SEED + 130, torch.device("cuda")).generator)
    for name in ("sharded", "one", "one", "sharded"):
        step = sharded_step if name == "sharded" else one_step
        gen = rng(SEED + 130, torch.device("cuda")).generator
        s = start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SWEEPS13):
            s = step(s, gen)
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / SWEEPS13)
        ends.setdefault(name, []).append(s)
    equal = all(same(e, ends["sharded"][0]) for e in ends["sharded"] + ends["one"])
    out = {"equal": equal, "sharded_ms": float(np.mean(ms["sharded"])), "one_device_ms": float(np.mean(ms["one"]))}
    log(f"(a) {what}: {SWEEPS13} sweeps a turn in 4 turns, sharded and one-device equal bit for bit: {equal}; "
        f"sharded {out['sharded_ms']:.2f} ms, one-device {out['one_device_ms']:.2f} ms a sweep")
    require(equal, f"world size 1: {what}: the sharded sweep differs from the one-device sweep")
    return out


def _collective(what: str, payload, group) -> dict:
    """The sweep's all_reduce alone on its payload: ms (CUDA events, NCCL) and MB."""
    from common_tpu_torch.parallel import mesh as mesh_mod

    ms = cuda_ms(lambda: mesh_mod.all_reduce_sum(payload, group), 5)
    mb = sum(t.numel() * t.element_size() for t in payload) / 1e6
    log(f"(a) {what}: the all_reduce of {mb:.2f} MB alone {ms:.3f} ms")
    return {"all_reduce_ms": ms, "all_reduce_mb": mb}


def _irm_views13(dev):
    """Phase 11's relation and its views on `dev`."""
    from common_tpu_torch import relational as irm
    from common_tpu_torch.data import sparse_ndarray_dataview

    rel, _ = irm_blocks(N11, BLOCKS11, SEED)
    return irm.as_views([sparse_ndarray_dataview(dense=rel, device=dev)])


def _phase13_ws1(tmp: str) -> dict:
    """(a): world size 1 over NCCL, the three sharded sweeps against their one-device sweeps."""
    import torch
    import torch.distributed as dist

    from common_tpu_torch import models, rng, topic
    from common_tpu_torch import relational as irm
    from common_tpu_torch.parallel import mesh as mesh_mod
    from common_tpu_torch.relational import kernels as irm_kernels

    dev = torch.device("cuda")
    mesh_mod.init_distributed("nccl", init_method=f"file://{tmp}/store_13a", world_size=1, rank=0)
    mesh = mesh_mod.make_mesh(1, 1, backend="nccl")
    rec = {}
    _zero_launches()

    gen = rng(SEED + 10, dev).generator
    words, mask, _ = hdp_corpus(dev, gen)
    data = topic.dense_token_data(words, mask)
    s0 = topic.initialize(data, K10, V10, gen, n_docs=D10)

    torch.cuda.reset_peak_memory_stats()
    s, w, m = topic.shard_dense_corpus(mesh, s0, words, mask)
    dense = topic.make_sharded_sweep_dense(mesh, s, w, m)
    rec["dense"] = _in_turns(
        f"doc-sharded dense sweep + sample_beta(mesh), {D10} docs x {L10}, K={K10}, V={V10}", s,
        lambda s, g: topic.sample_beta(dense(s, w, m, g, doc_chunk=CHUNK10), g, max_count=L10, mesh=mesh),
        lambda s, g: topic.sample_beta(topic.blocked_sweep_dense(s, words, mask, g, doc_chunk=CHUNK10), g,
                                       max_count=L10), _hdp_same)
    rec["dense"].update(_collective("doc-sharded sweep (topic_word)", [s0.topic_word], mesh.data_group))
    rec["dense"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del s, w, m

    torch.cuda.reset_peak_memory_stats()
    s, d = topic.shard_corpus(mesh, s0, data)
    flat = topic.make_sharded_sweep(mesh, s, d)
    rec["tokens"] = _in_turns(
        f"token-sharded sweep, {D10 * L10} tokens, chunk {CHUNK13}", s,
        lambda s, g: flat(s, d, g, chunk=CHUNK13),
        lambda s, g: topic.blocked_sweep(s, data, g, chunk=CHUNK13), _hdp_same)
    rec["tokens"].update(_collective("token-sharded sweep (doc_topic, topic_word, topic_total)",
                                     [s0.doc_topic, s0.topic_word, s0.topic_total], mesh.data_group))
    rec["tokens"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del s, d, s0, data, words, mask

    torch.cuda.reset_peak_memory_stats()
    views = _irm_views13(dev)
    defn = irm.model_definition([N11, N11], [((0, 1), models.bb)], k_max=K11)
    s0 = irm.initialize(defn, views, rng(SEED + 131, dev).generator, cluster_hps=[{"alpha": 1.0}] * 2)
    local = irm_kernels.shard_cells(mesh, views)
    sweep = irm_kernels.make_sharded_sweep(mesh, s0, local)
    # torch's default mode: the table and the suffstats are order-fixed segment sums
    rec["irm"] = _in_turns(f"cell-sharded IRM sweep, {N11} x {N11} bb, K_max={K11}", s0,
                           lambda s, g: sweep(s, local, g), lambda s, g: irm_kernels.sweep(s, views, g), _irm_same)
    table = torch.zeros((N11, K11), device=dev)
    payload = [table, table] + [t for st_r in s0.suffstats for t in st_r.values()]
    rec["irm"].update(_collective("IRM sweep (two [N_d, K] tables, then the suffstats)", payload,
                                  mesh.data_group))
    rec["irm"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    launched = _launches()
    dense_launches = (2 + 4 * SWEEPS13) * (D10 // CHUNK10)  # _in_turns: one untimed step a side, 4 turns
    require(launched["hdp_assign"] == dense_launches == sum(launched.values()),
            f"phase 13 (a) launches {launched}: not hdp_assign {dense_launches} times alone")
    for k in ("dense", "tokens", "irm"):
        log(f"(a) {k}: peak memory {rec[k]['peak_gib']:.2f} GiB")
    del views, local, s0, sweep, table, payload
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rec


def _gathered_hdp(mesh, s, dense: bool):
    """(z of all ranks, doc_topic of all ranks or the replicated one)."""
    from common_tpu_torch.parallel import mesh as mesh_mod

    z = mesh_mod.all_gather_cat(s.z, mesh.data_group)
    return z, mesh_mod.all_gather_cat(s.doc_topic, mesh.data_group) if dense else s.doc_topic


def _replicated_identical(mesh, leaves) -> bool:
    """Every rank holds the same leaves, bit for bit (one all_gather)."""
    import torch

    from common_tpu_torch.parallel import mesh as mesh_mod

    flat = torch.cat([t.reshape(-1).to(mesh.device, torch.float64) for t in leaves])
    every = mesh_mod.all_gather_cat(flat[None], mesh.data_group)
    return bool(torch.equal(every, every[:1].expand_as(every)))


def _timed_sweeps(step, s, n: int):
    import torch
    import torch.distributed as dist

    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        s = step(s)
    torch.cuda.synchronize()
    dist.barrier()
    return s, (time.perf_counter() - t0) / n


def _host_all_reduce_ms(payload, group) -> float:
    import torch
    import torch.distributed as dist

    from common_tpu_torch.parallel import mesh as mesh_mod

    ms = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_mod.all_reduce_sum(payload, group)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ms))


def _phase13_rank(rank, world, store, out, backend):
    """A rank of (b)/(c): the three sharded sweeps on a (1 x W) mesh."""
    import torch
    import torch.distributed as dist

    from common_tpu_torch import models, rng, topic
    from common_tpu_torch import relational as irm
    from common_tpu_torch.parallel import mesh as mesh_mod
    from common_tpu_torch.relational import kernels as irm_kernels
    from common_tpu_torch.topic import hdp

    torch.backends.cuda.matmul.allow_tf32 = False
    device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    if rank:  # rank 0 speaks for the ranks; a failure on any rank raises in the parent
        sys.stdout = open(os.devnull, "w")
    mesh_mod.init_distributed(backend, init_method=f"file://{store}", world_size=world, rank=rank)
    torch.cuda.set_device(torch.device(device))
    dev = torch.device(device)
    mesh = mesh_mod.make_mesh(1, world, backend=backend, device=device if backend == "gloo" else None)
    what = f"{backend} rank {rank}"
    rec = {}

    gen = rng(SEED + 10, dev).generator
    words, mask, _ = hdp_corpus(dev, gen)
    words, mask = words[:D13B].contiguous(), mask[:D13B].contiguous()
    data = topic.dense_token_data(words, mask)
    s0 = topic.initialize(data, K10, V10, gen, n_docs=D13B)

    # the token-sharded sweep and a beta move (doc_topic replicated: no mesh)
    s, d = topic.shard_corpus(mesh, s0, data)
    flat = topic.make_sharded_sweep(mesh, s, d)
    g = rng(SEED + 132, dev).generator
    s, sweep_s = _timed_sweeps(lambda s: topic.sample_beta(flat(s, d, g, chunk=CHUNK13), g, max_count=L10),
                               s, BSWEEPS13)
    z, dk = _gathered_hdp(mesh, s, dense=False)
    recount = hdp._counts(z, data, D13B, K10, V10)
    same = all(torch.equal(a, b) for a, b in zip((dk, s.topic_word, s.topic_total), recount))
    ident = _replicated_identical(mesh, [s.doc_topic, s.topic_word, s.topic_total, s.beta])
    require(same, f"{what}: token-sharded tables differ from a recount of the gathered z")
    require(ident, f"{what}: token-sharded replicated leaves differ across the ranks")
    rec["tokens"] = {"sweeps_per_s": 1.0 / sweep_s, "recount_equal": same, "replicated_identical": ident,
                     "all_reduce_ms": _host_all_reduce_ms([s.doc_topic, s.topic_word, s.topic_total],
                                                          mesh.data_group),
                     "all_reduce_mb": (s.doc_topic.numel() + s.topic_word.numel() + K10) * 4 / 1e6}
    del s, d, z, dk, recount

    # the doc-sharded sweep with the mesh's beta and concentration moves
    s, w, m = topic.shard_dense_corpus(mesh, s0, words, mask)
    dense = topic.make_sharded_sweep_dense(mesh, s, w, m)
    s, sweep_s = _timed_sweeps(lambda s: topic.sample_beta(dense(s, w, m, g, doc_chunk=CHUNK10), g, mesh=mesh),
                               s, BSWEEPS13)
    s = topic.sample_concentrations(s, g, max_count=L10, mesh=mesh)
    z, dk = _gathered_hdp(mesh, s, dense=True)
    recount = hdp._counts(z, data, D13B, K10, V10)
    same = all(torch.equal(a, b) for a, b in zip((dk, s.topic_word, s.topic_total), recount))
    ident = _replicated_identical(mesh, [s.topic_word, s.topic_total, s.beta, s.hypers["alpha"],
                                         s.hypers["gamma"], g.get_state()])
    require(same, f"{what}: doc-sharded tables differ from a recount of the gathered z")
    require(ident, f"{what}: doc-sharded replicated leaves (beta, alpha, gamma) differ across the ranks")
    rec["dense"] = {"sweeps_per_s": 1.0 / sweep_s, "recount_equal": same, "replicated_identical": ident,
                    "all_reduce_ms": _host_all_reduce_ms([s.topic_word], mesh.data_group),
                    "all_reduce_mb": s.topic_word.numel() * 4 / 1e6}
    del s, w, m, z, dk, recount, s0, data, words, mask

    # the cell-sharded IRM sweep on the full relation
    views = _irm_views13(dev)
    defn = irm.model_definition([N11, N11], [((0, 1), models.bb)], k_max=K11)
    s = irm.initialize(defn, views, rng(SEED + 131, dev).generator, cluster_hps=[{"alpha": 1.0}] * 2)
    local = irm_kernels.shard_cells(mesh, views)
    sweep = irm_kernels.make_sharded_sweep(mesh, s, local)
    s, sweep_s = _timed_sweeps(lambda s: sweep(s, local, g), s, BSWEEPS13)
    rebuilt = irm_kernels.restat(s, views)
    same = _irm_same(s, rebuilt)
    ident = _replicated_identical(mesh, list(s.assignments) + [t for st_r in s.suffstats for t in st_r.values()])
    require(same, f"{what}: IRM counts and suffstats differ from a rebuild")
    require(ident, f"{what}: IRM assignments and suffstats differ across the ranks")
    table = torch.zeros((N11, K11), device=dev)
    rec["irm"] = {"sweeps_per_s": 1.0 / sweep_s, "recount_equal": same, "replicated_identical": ident,
                  "cells_a_rank": int(local[0].indices.shape[0]),
                  "all_reduce_ms": _host_all_reduce_ms([table], mesh.data_group),
                  "all_reduce_mb": table.numel() * 4 / 1e6}
    launched = _launches()
    dense_launches = BSWEEPS13 * -(-(D13B // world) // CHUNK10)  # the rank's doc chunks a dense sweep
    require(launched["hdp_assign"] == dense_launches == sum(launched.values()),
            f"{what}: launches {launched}: not the dense sweeps' hdp_assign {dense_launches} times alone")
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def _spawn13(world: int, backend: str, tmp: str) -> list:
    from common_tpu_torch.parallel import mesh as mesh_mod

    out = os.path.join(tmp, f"p13_{backend}")
    mesh_mod.spawn(_phase13_rank, (world, os.path.join(tmp, f"store13_{backend}"), out, backend), world,
                   timeout_s=SPAWN_TIMEOUT12)
    recs = []
    for r in range(world):
        with open(f"{out}.{r}.json") as f:
            recs.append(json.load(f))
    return recs


def _log13(tag: str, recs: list, backend: str) -> None:
    for k, what in (("tokens", f"token-sharded sweep + beta, {D13B} docs x {L10}"),
                    ("dense", f"doc-sharded sweep + beta (mesh), {D13B} docs x {L10}"),
                    ("irm", f"cell-sharded IRM sweep, {N11} x {N11}")):
        r = recs[0][k]
        label = ("two processes on one card over gloo, a plumbing rate, not a multi-card one" if backend == "gloo"
                 else f"{len(recs)} cards over nccl")
        log(f"({tag}) {what}: {r['sweeps_per_s']:.3f} sweeps/s ({label}); the all_reduce of "
            f"{r['all_reduce_mb']:.2f} MB {r['all_reduce_ms']:.2f} ms; after {BSWEEPS13} sweeps the tables "
            f"equal a recount {r['recount_equal']}, replicated leaves identical on every rank "
            f"{r['replicated_identical']}")


def phase_sharded_families() -> dict:
    """Phase 13: the sharded HDP and IRM sweeps on the card (see the module docstring)."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p13_")
    rec = {"ws1": _phase13_ws1(tmp)}
    t0 = time.perf_counter()
    rec["gloo_2"] = _spawn13(2, "gloo", tmp)
    _log13("b", rec["gloo_2"], "gloo")
    log(f"(b) {time.perf_counter() - t0:.1f} s with the spawn and each rank's data")
    count = torch.cuda.device_count()
    if count >= 2:
        rec["nccl_cards"] = _spawn13(min(count, 4), "nccl", tmp)
        _log13("c", rec["nccl_cards"], "nccl")
    else:
        log(f"(c) one card found (torch.cuda.device_count() = {count}): no multi-card NCCL run")
    shutil.rmtree(tmp)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13 wall time {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 14: the port bench's smoke tiers, in-process
# ---------------------------------------------------------------------------
# phase 15: slots a likelihood, a slot's heads (bnb: zero counts), the hyper beta, bbv's columns;
# the all-heads DP mixture's rows, sweeps and K_max
DRAWS15, HEADS15, BETA15, D15 = 10_000, 1e6, 0.5, 100
N15, SWEEPS15, K15 = 1_000_000, 10, 8
BENCH_KEYS14 = ("metric", "value", "unit", "ess_per_s", "k_active", "tflops", "mfu", "peak_tflops",
                "device", "vs_baseline", "summary", "tiers", "fused_tier", "partial", "total_s")


def phase_bench_smoke(card: str) -> dict:
    """`python -m common_tpu_torch.bench --smoke` through its `main`: the
    first ladder shape by the plain sweep, then by the fused one (kernels 1
    and 2). Checks exit 0, the last line's layout (bench.py's keys with `mfu`
    and `peak_tflops`, the headline last, the card's line as `device`), and
    the fused tier's launches of kernels 1 and 2, one each a sweep of its
    warm-up and its timed run."""
    import contextlib
    import io

    from common_tpu_torch import bench

    t0 = time.perf_counter()
    out = io.StringIO()
    _zero_launches()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--smoke"])
    launched = _launches()
    wall = time.perf_counter() - t0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    fused = line["fused_tier"]
    log(f"bench --smoke: exit {rc} in {wall:.1f} s; {line['metric']}: {line['value']} {line['unit']}, fused tier "
        f"{fused['sweeps_per_s']:.2f} sweeps/s, mfu {line['mfu']}, device {line['device']!r}; launches {launched}, "
        f"the fused tier's {fused['launches']}")
    require(rc == 0 and line["partial"] is False, f"bench --smoke exited {rc}")
    missing = [k for k in BENCH_KEYS14 if k not in line]
    require(not missing and "mfu_vs_bf16_peak" not in line, f"bench line: keys missing {missing}")
    require(list(line)[-3:] == ["unit", "value", "metric"], f"bench line ends {list(line)[-3:]}")
    require(line["device"] == card and line["peak_tflops"] == bench.PEAK_TFLOPS, "bench line: device or peak")
    require(line["value"] > 0 and 0 <= line["mfu"] < 1, "bench line: value or mfu")
    want = 2 * fused["sweeps"]
    require(fused["launches"]["gaussian_assign"] == want and fused["launches"]["scatter_stats"] == want,
            f"fused tier launches {fused['launches']} != {want} of kernels 1 and 2")
    require(launched["fused_gaussian_assign"] == want and launched["fused_scatter_stats"] == want
            and not launched["fused_gaussian_assign_chains"] and not launched["fused_linear_assign"]
            and not launched["slice_update"],
            f"bench --smoke launches {launched}")
    return {"wall_s": wall, "value": line["value"], "fused_sweeps_per_s": fused["sweeps_per_s"],
            "mfu": line["mfu"], "launches": launched}


def _extreme15(name: str, dev):
    """(likelihood, hyper, stats, rows to score, (a, b) of its Beta draw) at phase 15's counts."""
    import torch

    from common_tpu_torch import likelihoods as lik

    def full(*shape, value):
        return torch.full(shape, float(value), device=dev)

    one, beta = torch.tensor(1.0, device=dev), torch.tensor(BETA15, device=dev)
    if name == "bbv":
        hyper = {"alpha": full(D15, value=1.0), "beta": full(D15, value=BETA15)}
        stats = {"n": full(DRAWS15 // D15, value=HEADS15), "heads": full(DRAWS15 // D15, D15, value=HEADS15)}
        X = torch.stack([full(D15, value=1.0), full(D15, value=0.0)])
    elif name == "bnb":
        hyper = {"alpha": one, "beta": beta, "r": one}
        stats = {"n": full(DRAWS15, value=HEADS15), "sum_x": full(DRAWS15, value=0.0),
                 "sum_log_coef": full(DRAWS15, value=0.0)}
        X = torch.tensor([0.0, 3.0], device=dev)
    else:
        hyper = {"alpha": one, "beta": beta}
        stats = {"n": full(DRAWS15, value=HEADS15), "heads": full(DRAWS15, value=HEADS15)}
        if name == "bbnc":
            stats["p"] = full(DRAWS15, value=0.5)
        X = torch.tensor([1.0, 0.0], device=dev)
    model = getattr(lik, name)
    if name == "bbnc":
        ab = (hyper["alpha"] + stats["heads"], hyper["beta"] + stats["n"] - stats["heads"])
    else:
        post = model.posterior_hyper(hyper, stats)
        ab = (post["alpha"], post["beta"])
    return model, hyper, stats, X, ab


def phase_support(dev=None) -> dict:
    """Phase 15: every Beta parameter the port draws lies inside (0, 1), on
    the card. Each likelihood's `sample_params` against a plain `rng.beta`
    from the same generator state (which must reach 1.0 there, or the check
    tests nothing), then 10 blocked sweeps of a DP mixture whose bb column
    is all heads: before `rng.beta_open` an unclamped draw of 1.0 scored
    every head NaN in its slot and argmax moved every row there."""
    import torch

    from common_tpu_torch import models
    from common_tpu_torch import state as st
    from common_tpu_torch.kernels import blocked
    from common_tpu_torch.rng import beta

    dev = dev or torch.device("cuda")
    t0 = time.perf_counter()
    cap = 1.0 - 2.0 ** -24
    draws = {}
    for name in ("bb", "bnb", "bbv", "bbnc"):
        model, hyper, stats, X, (a, b) = _extreme15(name, dev)
        theta = model.sample_params(_generator15(dev), hyper, stats)
        raw = beta(a, b, _generator15(dev))
        p = theta["p"]
        table = model.logpdf(theta, X[:, None]) if name == "bbnc" else model.logpdf_batch(
            theta, X, torch.ones(X.shape[0], device=dev))
        rec = {"draws": p.numel(), "at_0_or_1": int(((p <= 0) | (p >= 1)).sum()), "at_cap": int((p == cap).sum()),
               "plain_at_1": int((raw == 1).sum()), "capped_where_plain_1": bool((p[raw == 1] == cap).all()),
               "table_finite": bool(torch.isfinite(table).all())}
        log(f"phase 15 {name}: {rec['at_0_or_1']} of {rec['draws']} draws at 0 or 1, {rec['at_cap']} at the "
            f"largest float below 1; a plain rng.beta from the same generator state: {rec['plain_at_1']} at 1.0; "
            f"score table finite: {rec['table_finite']}")
        require(rec["plain_at_1"] > 0, f"phase 15 {name}: no plain draw reached 1.0, so the check tests nothing")
        require(rec["at_0_or_1"] == 0 and rec["capped_where_plain_1"] and rec["table_finite"],
                f"phase 15 {name}: a draw on the boundary or a score not finite: {rec}")
        draws[name] = rec

    g = _generator15(dev)
    z = (torch.arange(N15, device=dev) >= N15 // 2).to(torch.int32)
    x = torch.where(z > 0, 5.0, -5.0) + torch.randn(N15, generator=g, device=dev)
    ones = torch.ones(N15, device=dev)
    data = ((x, ones), (ones.clone(), ones))
    defn = st.model_definition(N15, [models.nich, models.bb], k_max=K15)
    s = st.initialize(defn, data, g, cluster_hp={"alpha": 1.0}, feature_hps=[None, {"alpha": 1.0, "beta": BETA15}],
                      assignment=z)
    k_trace, scores = [], []
    for _ in range(SWEEPS15):
        s = blocked.sweep(s, data, g)
        k_trace.append(int((s.counts > 0).sum()))
        scores.append(float(st.score_joint(s)))
    wall = time.perf_counter() - t0
    log(f"phase 15 all-heads DP mixture, {N15} rows, {SWEEPS15} blocked sweeps: k_active {k_trace}")
    log(f"phase 15 all-heads DP mixture: score_joint {scores[0]:.6g} .. {scores[-1]:.6g}, all finite: "
        f"{all(np.isfinite(scores))}")
    log(f"phase 15 wall time {wall:.1f} s")
    require(min(k_trace) > 1, f"phase 15: the all-heads mixture fell to one cluster: k_active {k_trace}")
    require(all(np.isfinite(scores)), f"phase 15: score_joint not finite: {scores}")
    return {"draws": draws, "k_trace": k_trace, "score_joint": scores, "wall_s": wall}


def _generator15(dev):
    import torch

    return torch.Generator(device=dev).manual_seed(SEED + 15)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one", file=sys.stderr)
        return 1
    try:
        env = phase_environment()
        checks = phase_kernels()
        headline = headline_data()
        result = phase_main_path(checks, headline)
        chains = phase_chains(headline)
        smc_out = phase_smc(headline)
        sm_out = phase_splitmerge(headline)
        del headline
        config2 = phase_config2()
        config3 = phase_config3()
        hdp_out = phase_hdp()
        irm_out = phase_irm()
        sharded_out = phase_sharded(result)
        families_out = phase_sharded_families()
        bench_out = phase_bench_smoke(env["card"])
        support = phase_support()
        collapsed = phase_collapsed()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    kernels = result.pop("kernels") + [chains.pop("kernel"), *config2.pop("kernels"), smc_out.pop("kernel")]
    log(json.dumps({"main_path": result, "chains": chains, "config2": config2, "config3": config3,
                    "collapsed": collapsed, "hdp": hdp_out, "irm": irm_out, "smc": smc_out, "split_merge": sm_out,
                    "sharded": sharded_out, "sharded_families": families_out, "bench_smoke": bench_out,
                    "support": support, "card": env["card"]}))
    log(json.dumps({"sharded_launches": {
        "sweep_world_size_1": sharded_out["launches_ws1"],
        "sweep_gloo_one_sweep_a_rank": {shape: [r[shape]["launches_one_sweep"] for r in sharded_out["gloo_2"]]
                                        for shape in ("1x2", "2x1")},
        "smc_world_size_1": sharded_out["smc_ws1"]["launches"],
        "smc_gloo_a_rank": [r["smc"]["launches"] for r in sharded_out["gloo_2"]]}}))
    log(json.dumps({"kernels": kernels}))
    log(env["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
