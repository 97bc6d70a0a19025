"""Tracing and timing (port of `common_tpu/utils/profiling.py`).

`trace` records a `torch.profiler` trace of the CPU and, where there is a
card, its kernels (CUPTI), and writes it for TensorBoard or Perfetto;
`device_memory_stats` reads the caching allocator's counters; `benchmark`
times a step with CUDA events after a warm-up, and `sweeps_per_second`
wraps it for a `step(state, ...)` kernel.

The program's own spans and counts: the samplers open `span(name)` around
their phases, read device values on the host through `read(tensor, site)`
and count work with `count(name)`. All three do nothing (one test of a
module-level flag; `read` is `tensor.item()`) until `recording()` turns
them on:

    with profiling.recording() as rec:
        run.run(generator, 10)
    rec.summary()["slice.update"]      # {"calls", "host_s", "self_s"}
    rec.reads()                        # host reads of device values, by site

Each span is kept as one row (name, start, end, parent) on the host's
`time.perf_counter_ns` clock; a read is a span named `read.<site>`, so its
host time is the time the host waited on the device. Under an active
`torch.profiler` (`trace`), each span is also a `record_function` range, so
the program's spans lie on the device trace's clock beside the kernels.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler



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


# ---------------------------------------------------------------------------
# the program's spans, host reads and counters
# ---------------------------------------------------------------------------
class Record:
    """What one `recording()` gathered.

    `spans`: a row [name, start_ns, end_ns, parent] a span, in the order
    the spans opened; parent is the row index of the enclosing span, -1 at
    the top, and end_ns 0 while the span is open. `counters`: name ->
    total of `count`. `start_ns`, `end_ns`: the recording's own bounds.
    """

    def __init__(self, profiled: bool):
        self.profiled = profiled
        self.spans: List[list] = []
        self.counters: Dict[str, int] = {}
        self.open: List[int] = []  # row indices of the spans open now, innermost last
        self.start_ns = time.perf_counter_ns()
        self.end_ns = 0

    @property
    def window_s(self) -> float:
        """Host seconds from the recording's start to its end (or to now)."""
        return ((self.end_ns or time.perf_counter_ns()) - self.start_ns) / 1e9

    def summary(self) -> Dict[str, Dict[str, float]]:
        """name -> {"calls", "host_s", "self_s"} over the closed spans.

        host_s is inclusive; self_s is each span's time less the time its
        child spans cover (children nest inside their parent, so their
        durations add up without overlap).
        """
        child_ns = [0] * len(self.spans)
        for name, start, end, parent in self.spans:
            if end and parent >= 0:
                child_ns[parent] += end - start
        out: Dict[str, Dict[str, float]] = {}
        for i, (name, start, end, _) in enumerate(self.spans):
            if not end:
                continue
            s = out.setdefault(name, {"calls": 0, "host_s": 0.0, "self_s": 0.0})
            s["calls"] += 1
            s["host_s"] += (end - start) / 1e9
            s["self_s"] += (end - start - child_ns[i]) / 1e9
        return out

    def reads(self, within: Optional[str] = None) -> Dict[str, int]:
        """Host reads by site (`read.<site>` spans), all of them or only
        those inside a span named `within`."""
        out: Dict[str, int] = {}
        for name, _, _, parent in self.spans:
            if not name.startswith("read."):
                continue
            if within is not None:
                while parent >= 0 and self.spans[parent][0] != within:
                    parent = self.spans[parent][3]
                if parent < 0:
                    continue
            site = name[len("read."):]
            out[site] = out.get(site, 0) + 1
        return out


_RECORD: Optional[Record] = None  # the open recording; None: spans, reads and counts are off
_OFF = contextlib.nullcontext()  # what `span` returns while off: nothing to build, nothing to time


class _Span:
    __slots__ = ("rec", "name", "row", "rf")

    def __init__(self, rec: Record, name: str):
        self.rec, self.name, self.rf = rec, name, None

    def __enter__(self):
        rec = self.rec
        if rec.profiled:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.row = len(rec.spans)
        rec.spans.append([self.name, time.perf_counter_ns(), 0, rec.open[-1] if rec.open else -1])
        rec.open.append(self.row)
        return None

    def __exit__(self, *exc):
        rec = self.rec
        rec.spans[self.row][2] = time.perf_counter_ns()
        rec.open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records the span `name` while `recording()`
    is on (and does nothing otherwise)."""
    if _RECORD is None:
        return _OFF
    return _Span(_RECORD, name)


def read(tensor: torch.Tensor, site: str):
    """`tensor.item()`, the host waiting on the device: recorded as the span
    `read.<site>` while `recording()` is on."""
    if _RECORD is None:
        return tensor.item()
    with _Span(_RECORD, "read." + site):
        return tensor.item()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while `recording()` is on."""
    rec = _RECORD
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Turn the program's spans, reads and counters on; yields the `Record`.

    Under an active `torch.profiler` each span is also a `record_function`
    range. A recording opened inside another one records alone until it
    closes.
    """
    global _RECORD
    outer = _RECORD
    rec = Record(profiled=bool(torch.autograd._profiler_enabled()))
    _RECORD = rec
    try:
        yield rec
    finally:
        rec.end_ns = time.perf_counter_ns()
        _RECORD = outer
