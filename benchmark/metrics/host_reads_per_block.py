"""`host_reads_per_block`: host reads of device values a block step of block-SMC, from the program's own record.

The record (`benchmark/program_record.py`) is one run of the cell's step, a
whole `run_blocked` pass over the rows, inside
`common_tpu_torch.utils.profiling.recording()`, with no profiler, in a child
of this run on its cell and seed. The reads are the `read.<site>` spans
inside the `smc.block_step` spans (the resampling check's ESS, and any
other wait of the host on the device in the seating or the
rejuvenation), over those spans; for one seed the count repeats exactly.
No value where the program has no recorder.
"""

from benchmark import program_record


def read(ctx):
    rec = program_record.record()
    blocks = rec["spans"].get("smc.block_step", {}).get("calls", 0) if rec else 0
    if blocks == 0:
        return None
    return sum(rec["block_reads"].values()) / blocks
