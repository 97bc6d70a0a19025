"""common_tpu_torch — the PyTorch / CUDA port of `common_tpu`.

A second package beside the JAX one, which stays the reference it is held
against. It carries the main path (a Dirichlet-process mixture with one
NIW feature, swept by blocked (uncollapsed) Gibbs), several such chains
swept together, and the Beta-Bernoulli config-2 model with slice-sampled
hypers. The JAX package's four Pallas kernels are rewritten by hand in
CUDA C++ for Hopper (`csrc/`, built with nvcc at first use).

Module map (each keeps its counterpart's name in `common_tpu`):
  - validator.py, runtime_types.py, rng.py, models.py, state.py, runner.py,
    scalar_functions.py
  - likelihoods/  base, the conjugate zoo and bbnc, expfam (SVI's expectations)
  - ops/          the CUDA kernels' wrappers and their plain versions
  - kernels/      blocked.py (sweep, sweep_fused, sweep_chains), slice_.py (hp),
                  hmc.py (NUTS: hp, cluster_hp, theta), svi.py (CAVI, SVI),
                  gibbs.py, smc.py (with its particle-sharded runs), splitmerge.py,
                  annealing.py
  - parallel/     chains.py (stack_states, unstack_state, vmap_sweep);
                  mesh.py (the (chains x data) process mesh over torch.distributed:
                  init_distributed, make_mesh, shard_state, the collectives);
                  sharded.py (the data- and chain-sharded blocked sweep, kernels 1
                  and 2 on each data shard); scaling.py (measure_row_scaling)
  - io/           checkpoint.py (serialize, deserialize, save, load);
                  loader.py (load_csv_f32, the C++ parser in native/loader.cpp)
  - utils/        diagnostics.py (ess, split_rhat, summarize_traces)
  - convert.py    (new) state to and from numpy leaves

Precision: the sampler runs in fp32. Reduced-precision products bias it
(common_tpu/likelihoods/niw.py, sample_params_prec), so importing the
package turns TF32 off for CUDA matmuls and cuDNN, and the fused sweep
refuses to run if it was turned back on.
"""

import torch

from common_tpu_torch import validator  # noqa: F401
from common_tpu_torch.rng import rng  # noqa: F401
from common_tpu_torch import models  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
