"""Utilities (port of `common_tpu/utils/`): MCMC diagnostics."""
