"""Utilities (port of `common_tpu/utils/`): MCMC diagnostics, numeric
helpers, tracing and timing."""
