"""Scenario-sweep evaluation launcher (port of `repro.launch.eval_marl`).

Runs any set of registered systems across any set of registered envs with
the greedy evaluator (`repro_torch.eval.sweep.run_sweep`), seeds as lanes
of one batch, and writes the sweep artifact: every (system, env) cell,
with its returns over seeds x episodes, robust aggregates (IQM and a
stratified-bootstrap 95% CI) and evaluation steps a second where it runs,
and the registry's reason where it does not.

  # the full system x env compatibility matrix
  PYTHONPATH=src python -m repro_torch.launch.eval_marl

  # a focused slice, with training before the evaluation
  PYTHONPATH=src python -m repro_torch.launch.eval_marl --systems qmix ippo \\
      --envs smax_lite --train-iterations 2000 --seeds 0 1 2

The arguments and defaults are the reference's, except ``--out``: it
defaults to ``results/port/BENCH_eval.json`` (the markdown beside it),
never the root's ``BENCH_eval.json``, which is the JAX package's.  It runs
on CUDA unless ``--device`` says otherwise, and raises when there is no
GPU and no ``--device``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.envs import REGISTRY as ENVS
from repro_torch.eval.sweep import DEFAULT_OUT, run_sweep
from repro_torch.obs import ConsoleSink
from repro_torch.systems.registry import REGISTRY as SYSTEMS


def parse_args(argv=None):
    """The sweep's command line."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--systems", nargs="+", choices=sorted(SYSTEMS) + ["all"], default=["all"],
                   help="registered systems to sweep, or 'all' for the full registry")
    p.add_argument("--envs", nargs="+", choices=sorted(ENVS) + ["all"], default=["all"],
                   help="registered envs to sweep, or 'all' for the full registry")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--eval-episodes", type=int, default=32)
    p.add_argument("--num-envs", type=int, default=16, help="parallel eval envs")
    p.add_argument("--train-iterations", type=int, default=0,
                   help="anakin training iterations per seed before eval (0 = evaluate "
                        "freshly initialised params)")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default=None, help="default: CUDA, raising without it")
    return p.parse_args(argv)


def run(args) -> dict:
    """Sweep as configured; returns the artifact."""
    device = resolve_device(args.device)
    system_names = sorted(SYSTEMS) if "all" in args.systems else args.systems
    env_names = sorted(ENVS) if "all" in args.envs else args.envs
    console = ConsoleSink()
    t0 = time.perf_counter()
    results = run_sweep(system_names=system_names, env_names=env_names, seeds=args.seeds,
                        num_episodes=args.eval_episodes, num_envs=args.num_envs,
                        train_iterations=args.train_iterations, out_path=args.out,
                        device=device)
    console.line(f"swept {len(system_names)} system(s) x {len(env_names)} env(s) in "
                 f"{time.perf_counter() - t0:.1f}s")
    return results


def main(argv=None):
    """Parse ``argv`` and sweep."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
