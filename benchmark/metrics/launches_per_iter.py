"""`launches_per_iter`: device kernels launched inside the hyper sampler, a call.

The kernels (and copies) whose launch lies inside the benchmark's
`slice_hp` range around the runner's `slice_hp` kernel (`kernels/slice_.py`
`hp`), over its calls in the traced window. The slice sampler decides each
step on the host, so its launches are what the host issues; for one seed
the count repeats exactly.
"""

RANGE = "slice_hp"


def read(ctx):
    r = ctx.ranges.get(RANGE)
    if not r or r["calls"] == 0 or r["launches"] == 0:
        return None
    return r["launches"] / r["calls"]
