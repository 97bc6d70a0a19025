"""Read a cell's compared numbers for the program and for the control, seed by seed.

    python -m benchmark.control --workload <cell> --seeds 11 12 13 [--seconds 3]

For each seed one process-local run of the cell (set-up, a short window,
the comparison), then the control: the reference in TF32 put in the
program's place at each stage of the same last sweep and judged the same
way. One JSON line a seed on standard output, with both readings beside the
cell's limits. The limits in `workloads/<cell>.json` are set from these
readings (the program's over a dozen seeds or more, the control's over three
or more). The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import cell_spec, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    modes = ("program", "control")
    for seed in args.seeds:
        out = run_cell(cell_spec(args.workload), seed, args.seconds, False, device, modes)
        print(json.dumps({"workload": args.workload, "seed": seed, "limits": {k: v["limit"] for k, v in out["checks"].items()},
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                          "readings": out["readings"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
