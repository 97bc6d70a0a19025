"""`crt_batches_per_sweep`: the CRT's Bernoulli batches a sweep, from the program's own record.

The record (`benchmark/program_record.py`) is one run of the cell's step
(`runner.run` of a chunk of dense sweeps, each with its CRT beta draw)
inside `common_tpu_torch.utils.profiling.recording()`, with no profiler, in
a child of this run on its cell and seed. The counter `hdp.crt_batches`
(one a batch of [D, K] Bernoulli draws, dependent on the one before) over the
`hdp.sweep` spans: today the longest document, 50, exact for one seed. No
value where the program has no recorder or no such counter.
"""

from benchmark import program_record


def read(ctx):
    rec = program_record.record()
    if not rec:
        return None
    sweeps = rec["spans"].get("hdp.sweep", {}).get("calls", 0)
    batches = rec["counters"].get("hdp.crt_batches")
    if sweeps == 0 or batches is None:
        return None
    return batches / sweeps
