"""Benchmark harness of the port: one module per paper table/figure.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast] [--only NAME] [--device DEV]

Prints ``name,us_per_call,derived`` CSV rows, as the JAX package's
``benchmarks/run.py`` does. Modules:

  speedup              JAX-rewrite 10-100x claim (python loop vs Anakin)
  switch_game          Fig 4 top — DIAL communication on the switch riddle
  value_decomposition  Fig 4 bottom — VDN vs MADQN (+QMIX) on smax-lite 3m
  architectures        Fig 6 — MAD4PG centralised vs decentralised; MPE
  distribution         Fig 6 bottom right — scaling with num_executors

The reference's ``roofline`` module reads the dry-run JSON of the
multi-card path, which the port does not have yet, so it is not here.
Every module runs on CUDA unless ``--device`` says otherwise; without a
GPU and without ``--device`` the harness raises.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

from repro_torch import resolve_device

MODULES = [
    "speedup",
    "switch_game",
    "value_decomposition",
    "architectures",
    "distribution",
]


def main(argv=None) -> None:
    """Run the figure modules and print their rows as CSV."""
    p = argparse.ArgumentParser()
    p.add_argument("--fast", action="store_true", help="reduced iteration counts")
    p.add_argument("--only", choices=MODULES, default=None)
    p.add_argument("--device", default=None, help="default: CUDA, raising without it")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    mods = [args.only] if args.only else MODULES
    print("name,us_per_call,derived")
    failed = []
    for name in mods:
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
        t0 = time.time()
        try:
            rows = mod.bench(fast=args.fast, device=device)
        except Exception:
            failed.append(name)
            traceback.print_exc()
            continue
        for row_name, us, derived in rows:
            print(f"{row_name},{us:.1f},{derived}")
        print(f"# {name} done in {time.time()-t0:.1f}s", file=sys.stderr)
        sys.stdout.flush()
    if failed:
        print(f"# FAILED: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
