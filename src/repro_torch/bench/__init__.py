"""repro_torch.bench: the throughput half of the port's measurement backbone.

Port of `repro.bench`.  `repro_torch.eval` answers "how well does it
play"; this package answers "how fast does it train": steps/sec for each
runner rung (python loop, Anakin, the sharded runner) and the
serial-vs-lanes seed speedup, emitted as the ``BENCH_speed.json``
artifact by `repro_torch.launch.bench_marl` (under ``results/port/``),
and the schema every port artifact is checked against.
"""
from repro_torch.bench.schema import (
    check_eval_schema,
    check_speed_schema,
    validate_path,
)
from repro_torch.bench.throughput import (
    SMOKE_OVERRIDES,
    bench_cell,
    measure_anakin,
    measure_python_loop,
    measure_seed_vectorization,
    measure_shard_map,
    run_bench,
    smoke_overrides,
    to_markdown,
)

__all__ = [
    "SMOKE_OVERRIDES",
    "bench_cell",
    "smoke_overrides",
    "check_eval_schema",
    "check_speed_schema",
    "measure_anakin",
    "measure_python_loop",
    "measure_seed_vectorization",
    "measure_shard_map",
    "run_bench",
    "to_markdown",
    "validate_path",
]
