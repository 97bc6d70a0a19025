"""The program's own record of one cell's step: its spans, host reads and counters.

    python3 -m benchmark.program_record --workload <cell> --seed <n> [--profile 1]

Builds the cell as `benchmark.run` does (its driver, the rows from the
seed, the program's start, the warm-up) but opens none of the benchmark's
ranges, then runs the cell's step once between two synchronisations inside
`common_tpu_torch.utils.profiling.recording()`, with no profiler: a whole
`run_blocked` pass in the smc cell, `runner.run` of a chunk in the runner's
cells. It prints to standard error a line a program span,

    span <name>: <calls> calls, <host s> s, <self s> s self

and `counter <name>: <n>`, then last on standard output one JSON line:

    {"window_s": ..., "spans": {name: {"calls", "host_s", "self_s"}},
     "counters": {...}, "reads": {site: n}, "block_reads": {site: n}}

`window_s` is the recorded step's host time; a read is a `read.<site>`
span (the host waiting on the device); `block_reads` counts the reads
inside `smc.block_step` spans.

With `--profile 1` it first traces the cell's traced step (the driver's
`trace_step` where it has one) under `torch.profiler` with the recorder on,
where every program span is also a profiler range, and prints the device's
idle seconds by the innermost program span the host was in at each idle
gap's middle: `idle_span <name>: <s>` ("(no program span)" outside them).

`record()` runs this module in a child process of a `--trace 1` run, on the
run's own cell and seed, for the per-layer metrics that read the program's
record (`metrics/host_reads_per_iter.py`, `host_reads_per_block.py`,
`read_wait_share.py`); a child keeps the run's own captures and memory
apart. Where the program has no recorder, or the run names no cell, it
returns None and starts nothing.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional

from benchmark import run

OUTSIDE = "(no program span)"
_CACHE: Dict[tuple, Optional[dict]] = {}


class NoRanges:
    """Stands in for `benchmark.spans.Spans`: the drivers' wraps do nothing,
    so the program runs with no range and no capture of the benchmark's."""

    def wrap(self, *args, **kwargs) -> None:
        pass


def profiling_module():
    """`common_tpu_torch.utils.profiling` where it has the recorder, else None."""
    from common_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "recording") else None


def summarize(rec) -> dict:
    """The JSON-ready record of one `recording()`."""
    return {"window_s": rec.window_s, "spans": rec.summary(), "counters": dict(rec.counters),
            "reads": rec.reads(), "block_reads": rec.reads(within="smc.block_step")}


def idle_by_span(events, program_names) -> List[list]:
    """[name, idle seconds] by the innermost program span covering each idle
    gap's middle, largest first. `events` are `benchmark.tracing.Event`s; a
    program span's device-side copy is no device work."""
    from benchmark import tracing

    names = set(program_names)
    device = [e for e in events if e.on_device and not e.annotation and e.name not in names]
    spans = [e for e in events if not e.on_device and e.name in names]
    merged = tracing._merged([(e.start_us, e.end_us) for e in device])
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    out: Dict[str, float] = {}
    for (s, e), name in zip(gaps, tracing._innermost_names(spans, [0.5 * (s + e) for s, e in gaps])):
        name = OUTSIDE if name not in names else name
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])]


def measure(spec, seed: int, device, profile: bool = False) -> dict:
    """Build and warm up the cell, then record its step (after a profiled
    record of its traced step with `profile`): the summary, with the idle
    seconds by program span under `idle_spans` where profiled."""
    import torch

    from benchmark import tracing

    profiling = profiling_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(f"benchmark.drivers.{spec.workload['driver']}")
    cell = driver.build(spec.config, spec.workload, seed, device, NoRanges())
    cell.warmup()
    run.sync(device)
    idle = None
    if profile:
        step = getattr(cell, "trace_step", cell.step)
        held = {}

        def traced():
            with profiling.recording() as rec:
                step()
            held["rec"] = rec

        events, _ = tracing.profile_window(traced, device)
        idle = idle_by_span(events, {row[0] for row in held["rec"].spans})
    run.sync(device)
    with profiling.recording() as rec:
        cell.step()
        run.sync(device)
    out = summarize(rec)
    if idle is not None:
        out["idle_spans"] = idle
    cell.finish()
    return out


def print_record(out: dict) -> None:
    for name, s in sorted(out["spans"].items(), key=lambda kv: -kv[1]["host_s"]):
        print(f"span {name}: {s['calls']} calls, {s['host_s']} s, {s['self_s']} s self", file=sys.stderr)
    for name, n in sorted(out["counters"].items()):
        print(f"counter {name}: {n}", file=sys.stderr)
    print(f"recorded window: {out['window_s']} s", file=sys.stderr)
    for name, s in out.get("idle_spans", []):
        print(f"idle_span {name}: {s}", file=sys.stderr)


def _cell_and_seed(argv) -> Optional[tuple]:
    """(cell, seed) that this process's command line names, or None."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    try:
        args, _ = ap.parse_known_args(argv)
    except SystemExit:
        return None
    return None if args.workload is None or args.seed is None else (args.workload, args.seed)


def record(argv=None, timeout_s: float = 900.0) -> Optional[dict]:
    """The program's record of this run's cell and seed (`--workload`,
    `--seed` of the command line), made once a process in a child; None
    where the program has no recorder, the command names no cell, or the
    child fails (its error goes to standard error)."""
    key = _cell_and_seed(sys.argv[1:] if argv is None else argv)
    if key is None or profiling_module() is None:
        return None
    if key not in _CACHE:
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "benchmark.program_record", "--workload", key[0], "--seed", str(key[1])]
        try:
            done = subprocess.run(cmd, cwd=run.ROOT, stdout=subprocess.PIPE, text=True, timeout=timeout_s)
            lines = done.stdout.strip().splitlines()
            _CACHE[key] = json.loads(lines[-1]) if done.returncode == 0 and lines else None
        except (OSError, subprocess.TimeoutExpired, ValueError) as exc:
            print(f"program_record: {exc!r}", file=sys.stderr)
            _CACHE[key] = None
        print(f"program_record: the child took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return _CACHE[key]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    spec = run.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("program_record: needs a CUDA device", file=sys.stderr)
        return 3
    if profiling_module() is None:
        print("program_record: the program has no recorder (utils.profiling.recording)", file=sys.stderr)
        return 5
    out = measure(spec, args.seed, torch.device("cuda", 0), bool(args.profile))
    print_record(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
