"""Tracing and timing (port of `common_tpu/utils/profiling.py`).

`trace` records a `torch.profiler` trace of the CPU and, where there is a
card, its kernels (CUPTI), and writes it for TensorBoard or Perfetto;
`device_memory_stats` reads the caching allocator's counters; `benchmark`
times a step with CUDA events after a warm-up, and `sweeps_per_second`
wraps it for a `step(state, ...)` kernel.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

named_scope = record_function  # per-stage annotation in traces


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace context: yields the profiler (for `key_averages()`), writes the
    trace under `log_dir` on exit (TensorBoard, or chrome://tracing)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def device_memory_stats(device=None) -> Dict[str, Any]:
    """The caching allocator's counters for a CUDA device (the card unless
    named): `allocated_bytes.all.peak` and so on. Empty for a CPU device."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 2, device="cuda") -> Dict[str, float]:
    """Seconds a call of fn(*args): `warmup` untimed calls, then `iters`
    calls each timed by its own pair of CUDA events, synchronised.

    device="cpu" times on the host clock instead, for work the caller put on
    the CPU; without a card the default raises.
    Returns {'mean_s', 'min_s', 'median_s', 'iters_per_s'}.
    """
    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("benchmark on the card needs a CUDA device; pass device='cpu' to time the CPU")
    for _ in range(max(warmup, 1)):
        fn(*args)
    ts = []
    for _ in range(iters):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return {"mean_s": float(ts.mean()), "min_s": float(ts.min()),
            "median_s": float(np.median(ts)), "iters_per_s": float(1.0 / np.median(ts))}


def sweeps_per_second(step: Callable, state, *args, iters: int = 10, **kw) -> float:
    """Median sweeps/s of a `step(state, ...) -> state` kernel."""
    return benchmark(step, state, *args, iters=iters, **kw)["iters_per_s"]
