"""The share of the host's time spent waiting on device reads, in %, from the program's own record.

The record (`benchmark/program_record.py`) is one run of the cell's step
(an iteration in the slice_hp cell, a whole pass over the rows in the smc
cell) inside `common_tpu_torch.utils.profiling.recording()`, with no
profiler, in a child of this run on its cell and seed, between two
synchronisations. 100 x the host seconds inside `read.<site>` spans (each
the host blocked on a device value) over the recorded step's host time. It
reads every `read_wait_share.<rate>` metric: the part after the dot says
which end-to-end rate that one moves. No value where the program has no
recorder.
"""

from benchmark import program_record


def read(ctx):
    rec = program_record.record()
    if not rec or rec["window_s"] <= 0:
        return None
    wait = sum(s["host_s"] for name, s in rec["spans"].items() if name.startswith("read."))
    return 100.0 * wait / rec["window_s"]
