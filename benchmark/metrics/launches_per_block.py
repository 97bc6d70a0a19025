"""`launches_per_block`: device kernels launched a block step of block-SMC.

The kernels (and copies) whose launch lies inside the benchmark's
`seat_block` and `rejuv_block` ranges, around `kernels/smc.py`'s
`_seat_block` (the proposal, its seating and the suffstat rebuild) and
`_rejuv_block` (a seated window re-assigned), over the block steps of the
traced pass. The block step is issued from the host, so these are the
launches the host makes a block; for one seed the count repeats.
"""


def read(ctx):
    seat, rejuv = ctx.ranges.get("seat_block"), ctx.ranges.get("rejuv_block")
    if not seat or seat["calls"] == 0 or seat["launches"] == 0:
        return None
    return (seat["launches"] + (rejuv["launches"] if rejuv else 0)) / seat["calls"]
