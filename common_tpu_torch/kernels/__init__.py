"""MCMC kernels (port of `common_tpu/kernels/`): `blocked` and `slice_`."""
