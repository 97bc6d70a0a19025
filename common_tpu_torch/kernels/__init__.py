"""MCMC and inference kernels (port of `common_tpu/kernels/`): blocked Gibbs
(`blocked`), collapsed Gibbs (`gibbs`), NUTS/HMC (`hmc`), slice sampling
(`slice_`), block-SMC (`smc`) and CAVI/SVI (`svi`), each importable as an
attribute as in the JAX package; `splitmerge` and `annealing` by their
module path."""

from common_tpu_torch.kernels import blocked, gibbs, hmc, slice_, smc, svi  # noqa: F401
