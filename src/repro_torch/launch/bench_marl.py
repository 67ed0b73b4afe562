"""Training-throughput launcher (port of `repro.launch.bench_marl`).

Times every runner rung (python loop / Anakin / the sharded runner), the
serial-vs-lanes seed speedup, the fused recurrent core and the async
actors for a systems x envs slice (`repro_torch.bench.throughput`), and
writes the ``BENCH_speed.json`` + ``BENCH_speed.md`` artifact (schema in
docs/BENCH.md, the port's differences in docs/PORT_BENCH.md; validated by
``scripts/check_port_bench_schema.py``).

  # the default slice (vdn + ippo + rec_ippo on matrix_game + spread + lbf)
  PYTHONPATH=src python -m repro_torch.launch.bench_marl

  # a small slice on the CPU
  PYTHONPATH=src python -m repro_torch.launch.bench_marl --systems vdn ippo \\
      --envs matrix_game --iterations 64 --num-envs 4 --num-seeds 4 --device cpu

The arguments and defaults are the reference's, except ``--out``: it
defaults to ``results/port/BENCH_speed.json`` (the markdown beside it),
never the root's ``BENCH_speed.json``, which is the JAX package's.  Every
system runs at the smoke operating point (`repro_torch.bench.
SMOKE_OVERRIDES`), as the reference's launcher runs it; each config's
registry defaults are `run_bench`'s ``system_overrides={name: {}}``
(docs/PORT_BENCH.md).  It runs on CUDA unless ``--device`` says
otherwise, and raises when there is no GPU and no ``--device``.
"""
from __future__ import annotations

import argparse
import contextlib

from repro_torch import resolve_device
from repro_torch.bench.throughput import DEFAULT_OUT, run_bench
from repro_torch.envs import REGISTRY as ENVS
from repro_torch.obs import ConsoleSink, profile_trace
from repro_torch.systems.registry import REGISTRY as SYSTEMS


def parse_args(argv=None):
    """The bench's command line."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--systems", nargs="+", choices=sorted(SYSTEMS) + ["all"],
        default=["vdn", "ippo", "rec_ippo"],
        help="systems to bench (default: one replay, one on-policy and "
        "one recurrent family)",
    )
    p.add_argument(
        "--envs", nargs="+", choices=sorted(ENVS) + ["all"],
        default=["matrix_game", "spread", "lbf"],
        help="envs to bench (default: the cheapest classic pair plus one "
        "gridworld, covering the fused-recurrent rung's pinned envs)",
    )
    p.add_argument("--iterations", type=int, default=256,
                   help="anakin training iterations per timed call")
    p.add_argument("--num-envs", type=int, default=4,
                   help="envs per run (and per rank for the sharded runner)")
    p.add_argument("--num-seeds", type=int, default=8,
                   help="seeds for the serial-vs-lanes comparison")
    p.add_argument("--loop-episodes", type=int, default=3,
                   help="episodes for the python-loop baseline timing")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the whole bench into DIR "
        "(see docs/PORT_OBSERVABILITY.md on reading traces)",
    )
    p.add_argument("--device", default=None, help="default: CUDA, raising without it")
    return p.parse_args(argv)


def run(args) -> dict:
    """Bench as configured; returns the artifact."""
    device = resolve_device(args.device)
    system_names = sorted(SYSTEMS) if "all" in args.systems else args.systems
    env_names = sorted(ENVS) if "all" in args.envs else args.envs
    trace_ctx = (
        profile_trace(args.profile) if args.profile
        else contextlib.nullcontext({})
    )
    with trace_ctx as trace_info:
        results = run_bench(
            system_names=system_names,
            env_names=env_names,
            iterations=args.iterations,
            num_envs=args.num_envs,
            num_seeds=args.num_seeds,
            loop_episodes=args.loop_episodes,
            out_path=args.out,
            device=device,
        )
    if args.profile:
        ConsoleSink().write(trace_info)
    return results


def main(argv=None):
    """Parse ``argv`` and bench."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
