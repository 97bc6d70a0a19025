"""Run one cell of BENCHMARK.json on the card and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start: imports, the kernels' build on a checkout's
first run, the rows made on the card from the seed, the program's start,
the cell's warm-up) ends where the window starts. With `--trace 0` the
window runs the cell's steps until `--seconds` have passed, the step in
flight finishing, and the rate is all the work over all the window's time.
With `--trace 1` it traces the cell's `trace_steps` steps instead (a
driver's `trace_step` where it has one) and reports the cell's per-layer
metrics. Either way the comparison with the
plain reference then judges what the timed path produced, and its numbers
go to standard error and, under `checks`, last into the result line, the
last line of standard output:

    {"correct": ..., "attempted": ..., "failed": ..., "metrics": {...},
     "device": {...}, ["breakdown": {...},] "checks": {...}}

Without a card, with fewer cards than the cell asks for, or with JAX or the
JAX package loaded once the window has closed, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "common_tpu")


def process_seconds() -> float:
    """Seconds since this process started (from /proc; since import elsewhere)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is JAX's or the JAX
    package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str) -> SimpleNamespace:
    """The cell's entry, workload file, configuration and metrics from BENCHMARK.json."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(ROOT / config_entry["file"])

    def reported(metric, e2e_names):
        if "workloads" in metric:
            return name in metric["workloads"]
        return metric.get("moves", metric["name"]) in e2e_names

    e2e = [m for m in bench["end_to_end"] if reported(m, {m["name"] for m in bench["end_to_end"]})]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reported(m, e2e_names)]
    return SimpleNamespace(name=name, entry=entry, workload=workload, config=config,
                           end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    """The reader of a per-layer metric: `metrics/<name>.py`, or for a dotted
    name without a file of its own, the file of the part before its first dot
    (`idle_share.sweep` reads with `idle_share.py`)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number at most its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        value = float(value) if value is not None else math.inf
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value if math.isfinite(value) else str(value), "limit": limit}
    return ok, checks


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec, seed: int, seconds: float, trace: bool, device, modes=("program",)) -> dict:
    """Set up, warm up, run the window and judge one cell on `device`: the
    result line's parts, judged on the first of `modes`, with the readings
    of each mode under `readings` ("control": the control's)."""
    import torch

    from benchmark.spans import Spans
    from benchmark import peaks as peaks_mod
    from benchmark import tracing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(f"benchmark.drivers.{spec.workload['driver']}")
    spans = Spans()
    try:
        phases = {"before the cell": process_seconds()}
        cell = driver.build(spec.config, spec.workload, seed, device, spans)
        sync(device)
        phases["inputs and the program's start"] = process_seconds()
        cell.warmup()
        sync(device)
        setup_s = phases["warm-up"] = process_seconds()
        work, steps = 0, 0
        result = {}
        if not trace:
            t0 = time.perf_counter()
            while True:
                work += cell.step()
                steps += 1
                sync(device)
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds:
                    break
            values = {m["name"]: work / elapsed for m in spec.end_to_end}
            values["setup_s"] = setup_s
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in spec.end_to_end}
        else:
            counter = {"work": 0, "steps": 0}

            step = getattr(cell, "trace_step", cell.step)  # a driver may trace a shorter step

            def traced():
                for _ in range(int(spec.workload["trace_steps"])):
                    counter["work"] += step()
                    counter["steps"] += 1

            spans.tracing = True
            events, window_s = tracing.profile_window(traced, device)
            spans.tracing = False
            work, steps = counter["work"], counter["steps"]
            red = tracing.reduce_events(events, window_s, spans.names)
            name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
            ctx = SimpleNamespace(ranges=red.ranges, busy_s=red.busy_s, window_s=red.window_s,
                                  work=work, steps=steps, shape=cell.shape, device_name=name,
                                  peaks=peaks_mod.peaks(name))
            metrics = {}
            for m in spec.per_layer:
                value = metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["trace"] = red
        cell.finish()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        readings = {mode: cell.readings(mode) for mode in modes}
    finally:
        spans.restore()
    correct, checks = judge(readings[modes[0]], spec.workload["limits"])
    result.update(correct=correct, attempted=steps, failed=0, metrics=metrics, peak=peak, checks=checks,
                  readings=readings, phases=phases)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = cell_spec(args.workload)
    import torch

    chips = int(spec.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 4
    line = {
        "correct": out["correct"],
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": out["metrics"],
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                   "memory_peak_bytes": int(out["peak"]), "power_limit": card_power_limit()},
    }
    if args.trace:
        red = out["trace"]
        line["device"].update(busy_s=red.busy_s, window_s=red.window_s)
        line["breakdown"] = {"device_ops": red.device_ops, "idle_gaps": red.idle_gaps}
        for name, r in sorted(red.ranges.items()):
            print(f"range {name}: {r['device_s']} device s, {r['launches']} launches, {r['calls']} calls",
                  file=sys.stderr)
    ends = list(out["phases"].items())
    print("setup: " + ", ".join(f"{name} {end - (ends[i - 1][1] if i else 0.0):.3f} s"
                                for i, (name, end) in enumerate(ends)), file=sys.stderr)
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
