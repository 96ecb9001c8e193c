"""The port's benchmark harness: one run of one cell of ``BENCHMARK.json``.

Everything a cell is made of is data found by name: the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<traffic>.json``),
the correctness limits (``limits/<workload>.json``) and each per-layer
metric's reader (``metrics/<metric>.py``).  The modules here are the
yardstick: traffic generation, the wave former and the windows, the
profiler's reduction, the operation and byte counts, the peaks and the
comparison with the plain reference (``portbench/reference``).
"""
