#!/usr/bin/env python
"""Validate the PyTorch port's benchmark artifacts against their schema.

    python scripts/check_port_bench_schema.py results/port/BENCH_speed.json
    python scripts/check_port_bench_schema.py --full results/port/BENCH_eval.json ...

The port's counterpart of ``scripts/check_bench_schema.py``: the same
checks through `repro_torch.bench.schema`, whose provenance block is the
port's (``torch_version`` for ``jax_version``; on a GPU the card's name
and power limit, docs/PORT_BENCH.md).  Exits non-zero, listing every
problem, when an artifact (BENCH_speed / BENCH_eval / BENCH_serve or a
``run.json`` record) has drifted; ``--full`` also enforces the coverage
pins of a full artifact.

It loads ``src/repro_torch/bench/schema.py`` straight from its file, so it
runs without torch (importing the `repro_torch` package would pull it in).
"""
import importlib.util
import pathlib
import sys

_SCHEMA_PY = (
    pathlib.Path(__file__).resolve().parent.parent
    / "src" / "repro_torch" / "bench" / "schema.py"
)
_spec = importlib.util.spec_from_file_location("repro_torch_bench_schema", _SCHEMA_PY)
_schema = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_schema)


def main(paths):
    full = "--full" in paths
    paths = [p for p in paths if p != "--full"]
    if not paths:
        print(
            "usage: check_port_bench_schema.py [--full] ARTIFACT.json "
            "[ARTIFACT.json ...]"
        )
        return 2
    failed = False
    for path in paths:
        errs = _schema.validate_path(path, full=full)
        if errs:
            failed = True
            print(f"{path}: {len(errs)} schema problem(s)")
            for e in errs:
                print(f"  - {e}")
        else:
            print(f"{path}: schema OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
