"""The port's benchmark: cells named in BENCHMARK.json, run one at a time.

`run.py` is the entry point.  Each configuration (`configs/`), traffic
mix (`traffic/`), per-layer metric (`metrics/`) and cell's correctness
limits (`limits/`) is a file of its own, found by the name that
BENCHMARK.json gives.  The plain references (`reference/`) import nothing
of the program; the drivers (`drivers/`) drive the program's public entry
points and hand their outputs to the references to be judged.
"""
