"""The device's idle share over the traced window, in %.

Busy time is the union of the device's kernel, copy and set intervals in
the trace; the window is the traced steps' host clock between two
synchronisations. It reads every `idle_share.<rate>` metric: the part
after the dot says which end-to-end rate that one moves.
"""


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
