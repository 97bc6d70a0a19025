"""Traffic loops, one file each, named by a workload's `driver`.

A driver module has `build(config, workload, seed, device, spans)`, which
returns a cell with `warmup()`, `step()` (one unit of the window's work;
returns the work it completed in the unit of the cell's rate), optionally
`trace_step()` (what a traced run steps instead, where a step is too long
to trace), `shape`
(the sizes the per-layer metrics count with), `finish()` (frees the
program's state and keeps what the comparison needs) and `readings(mode)`
(each compared number of the program's outputs, or with mode "control"
of the control's, by name).
"""
