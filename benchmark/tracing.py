"""The traced window and its reduction to per-range device time, busy time and gaps.

`profile_window(fn)` runs fn() under `torch.profiler` (CPU and CUDA
activity, no shapes, no stacks, nothing written to disk) between two
device synchronisations and returns the events as plain `Event`s.
`reduce_events` turns them into what the per-layer metrics read:

- `busy_s`: the union of the device's kernel, copy and set intervals;
- per range name: the device seconds, the kernels launched and the calls,
  a kernel counted in a range when the host call that launched it (the
  runtime event with the kernel's correlation id) lies inside the range;
- `device_ops`: device seconds by kernel name; `idle_gaps`: the device's
  idle seconds by the innermost host event running at each gap's middle.

The reduction works on plain records, so it is tested on the CPU.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

import torch

RUNTIME_PREFIXES = ("cuda", "cu")


@dataclass
class Event:
    name: str
    on_device: bool
    start_us: float
    end_us: float
    corr: int = 0
    annotation: bool = False


@dataclass
class Reduced:
    busy_s: float
    window_s: float
    ranges: Dict[str, dict] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def _merged(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost_names(cpu: List[Event], points: List[float]) -> List[str]:
    """For each time point (sorted), the innermost host event covering it."""
    order = sorted(cpu, key=lambda e: e.start_us)
    active: List[Event] = []
    names, i = [], 0
    for t in points:
        while i < len(order) and order[i].start_us <= t:
            active.append(order[i])
            i += 1
        active = [e for e in active if e.end_us >= t]
        names.append(max(active, key=lambda e: e.start_us).name if active else "(host: Python between ops)")
    return names


def reduce_events(events: Iterable[Event], window_s: float, range_names: Iterable[str],
                  top: int = 10) -> Reduced:
    events = list(events)
    range_names = set(range_names)
    for e in events:
        # the benchmark's ranges, on the host and as the profiler's device-side copies
        e.annotation = e.annotation or e.name in range_names
    device = [e for e in events if e.on_device and not e.annotation]
    cpu = [e for e in events if not e.on_device]
    # the runtime calls that launch device work (cudaLaunchKernel, cuLaunchKernel,
    # cudaMemcpyAsync, ...) share their kernel's correlation id
    launch_at = {e.corr: e.start_us for e in cpu
                 if e.corr and not e.annotation and e.name.startswith(RUNTIME_PREFIXES)}
    ranges, starts, spans_of = {}, {}, {}
    for name in range_names:
        raw = [(e.start_us, e.end_us) for e in cpu if e.annotation and e.name == name]
        spans_of[name] = _merged(raw)  # nested calls of one name count once
        starts[name] = [s for s, _ in spans_of[name]]
        ranges[name] = {"device_s": 0.0, "launches": 0, "calls": len(raw)}
    by_op: Dict[str, float] = {}
    for e in device:
        dur = (e.end_us - e.start_us) / 1e6
        by_op[e.name] = by_op.get(e.name, 0.0) + dur
        t = launch_at.get(e.corr)
        if t is None:
            continue
        for name, spans in spans_of.items():
            j = bisect.bisect_right(starts[name], t) - 1
            if j >= 0 and t <= spans[j][1]:
                ranges[name]["device_s"] += dur
                ranges[name]["launches"] += 1
    merged = _merged([(e.start_us, e.end_us) for e in device])
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    mids = [0.5 * (s + e) for s, e in gaps]
    gap_by: Dict[str, float] = {}
    for (s, e), name in zip(gaps, _innermost_names([c for c in cpu if not c.annotation], mids)):
        gap_by[name] = gap_by.get(name, 0.0) + (e - s) / 1e6
    return Reduced(
        busy_s=sum(e - s for s, e in merged) / 1e6,
        window_s=window_s,
        ranges=ranges,
        device_ops=[[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[k, v] for k, v in sorted(gap_by.items(), key=lambda kv: -kv[1])[:top]],
    )


def _events_of(prof) -> List[Event]:
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        on_device = e.device_type == DeviceType.CUDA
        out.append(Event(
            name=e.name, on_device=on_device, start_us=e.time_range.start, end_us=e.time_range.end,
            corr=int(getattr(e, "id", 0) or 0), annotation=bool(getattr(e, "is_user_annotation", False)),
        ))
    return out


def profile_window(fn: Callable[[], None], device: Optional[torch.device] = None):
    """(events, window seconds) of fn() traced between two synchronisations."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_card = device is not None and device.type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return _events_of(prof), window_s
