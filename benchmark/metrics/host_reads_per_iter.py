"""`host_reads_per_iter`: host reads of device values an iteration, from the program's own record.

The record (`benchmark/program_record.py`) is one run of the cell's step
(`runner.run` of one iteration: a fused sweep and the slice sampler on the
129 hypers) inside `common_tpu_torch.utils.profiling.recording()`, with no
profiler, in a child of this run on its cell and seed. A read is a
`read.<site>` span, the host waiting on the device: the slice sampler's
step-out and shrink tests, the runner's copy of the traces and its
saturation test. Over the `runner.step` spans; for one seed the count
repeats exactly. No value where the program has no recorder.
"""

from benchmark import program_record


def read(ctx):
    rec = program_record.record()
    steps = rec["spans"].get("runner.step", {}).get("calls", 0) if rec else 0
    if steps == 0:
        return None
    return sum(rec["reads"].values()) / steps
