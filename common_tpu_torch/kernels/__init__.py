"""MCMC kernels (port of `common_tpu/kernels/`); this slice carries `blocked`."""
