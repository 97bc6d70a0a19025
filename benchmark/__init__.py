"""The benchmark of `common_tpu_torch` on one NVIDIA H100.

`python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` and prints one JSON line last. Everything
that belongs to one configuration, cell, traffic loop or per-layer metric
is a file of its own, found by name:

  configs/<config>.json      shapes, data recipe, hypers, source
  workloads/<cell>.json      its configuration, driver, traffic parameters,
                             the limits of its correctness comparison
  drivers/<driver>.py        a traffic loop: set-up, warm-up, a step, the
                             capture of what the timed path produced, and the
                             comparison with the plain reference
  metrics/<metric>.py        a per-layer metric's reader (and, for a roofline,
                             its operation and byte counts)
  reference/                 the plain reference (torch and numpy only; it
                             imports nothing of the program)
  tests/                     the benchmark's own tests

The program under test, `common_tpu_torch`, is imported only by the drivers.
"""
