"""MARL decision-serving launcher (port of `repro.launch.serve_marl`).

Serves restored policy checkpoints (any registry system, feed-forward or
recurrent) behind the `repro_torch.serve.DecisionEngine` slot pool
against reproducible synthetic traffic (Poisson episode arrivals over N
concurrent user streams), and writes the latency/throughput artifact:
p50/p99 milliseconds a decision and decisions a second at every slot
count asked for, with the card's provenance and ``"framework": "torch"``.

Two ways in:

  # serve checkpoints already trained (train_marl --save-checkpoint)
  PYTHONPATH=src python -m repro_torch.launch.serve_marl \\
      --checkpoints results/port/ckpt/rec_ippo --slots 2 8

  # or train-then-serve: short anakin runs at the smoke operating point,
  # each saved and restored before it is served
  PYTHONPATH=src python -m repro_torch.launch.serve_marl \\
      --systems ippo rec_ippo --env matrix_game --train-iterations 512

The arguments and defaults are the reference's but for where the files
go: the artifact defaults to ``results/port/BENCH_serve.json`` (with its
markdown beside it), never the root's ``BENCH_serve.json``, which is the
JAX package's, and train-then-serve checkpoints to ``results/ckpts``, as
the reference's.  It runs on CUDA unless ``--device`` says otherwise, and
raises when there is no GPU and no ``--device``.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch import resolve_device
from repro_torch.envs import REGISTRY as ENVS
from repro_torch.obs import ConsoleSink, provenance
from repro_torch.serve import (
    DecisionEngine,
    load_policy,
    poisson_requests,
    read_policy_meta,
    save_policy,
    serve_workload,
)
from repro_torch.systems.registry import REGISTRY as SYSTEMS

DEFAULT_OUT = "results/port/BENCH_serve.json"


def parse_args(argv=None):
    """The serving command line."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoints", nargs="+", default=None, metavar="DIR",
                   help="policy checkpoint directories to serve (default: train short "
                        "checkpoints for --systems on --env first)")
    p.add_argument("--systems", nargs="+", choices=sorted(SYSTEMS), default=["ippo", "rec_ippo"],
                   help="systems to train-then-serve when no --checkpoints are given")
    p.add_argument("--env", choices=sorted(ENVS), default="matrix_game")
    p.add_argument("--train-iterations", type=int, default=512,
                   help="anakin iterations for the train-then-serve checkpoints")
    p.add_argument("--train-num-envs", type=int, default=8)
    p.add_argument("--ckpt-dir", default="results/ckpts",
                   help="where train-then-serve writes its checkpoints")
    p.add_argument("--slots", type=int, nargs="+", default=[2, 8],
                   help="slot-pool sizes to serve at (one cell each)")
    p.add_argument("--streams", type=int, default=8,
                   help="concurrent user streams generating Poisson episode arrivals")
    p.add_argument("--episodes-per-stream", type=int, default=4)
    p.add_argument("--arrival-rate", type=float, default=0.2,
                   help="episode requests per tick per stream (exponential gaps)")
    p.add_argument("--mode", choices=("greedy", "sample"), default="greedy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default=None, help="default: CUDA, raising without it")
    return p.parse_args(argv)


def _train_checkpoints(args, console, device) -> list:
    """Train short anakin runs and save them as policy checkpoints."""
    from repro_torch.core.system import train_anakin
    from repro_torch.systems.registry import make_pair, smoke_overrides

    dirs = []
    for name in args.systems:
        overrides = smoke_overrides(name)
        _, system = make_pair(name, args.env, **overrides)
        st, _ = train_anakin(system, args.seed, args.train_iterations, args.train_num_envs,
                             device=device)
        directory = str(pathlib.Path(args.ckpt_dir) / f"{name}-{args.env}")
        save_policy(directory, name, args.env, st.train, config_overrides=overrides,
                    step=args.train_iterations)
        console.line(f"trained + saved checkpoint: {directory}")
        dirs.append(directory)
    return dirs


def serve_cell(directory: str, max_slots: int, args, device) -> dict:
    """One cell: a restored checkpoint under one slot count."""
    _, system, train = load_policy(directory, device=device)
    engine = DecisionEngine(system, train, max_slots=max_slots, mode=args.mode, seed=args.seed,
                            device=device)
    requests = poisson_requests(args.streams, args.episodes_per_stream, args.arrival_rate,
                                seed=args.seed)
    stats = serve_workload(engine, requests)
    return {"checkpoint": directory, "max_slots": max_slots, **stats}


def run(args) -> dict:
    """Serve every checkpoint at every slot count; write the artifact and return it."""
    device = resolve_device(args.device)
    console = ConsoleSink()
    dirs = (_train_checkpoints(args, console, device) if args.checkpoints is None
            else list(args.checkpoints))
    results = {
        "workload": "serve",
        "framework": "torch",
        "provenance": provenance(device),
        "config": {
            "streams": args.streams,
            "episodes_per_stream": args.episodes_per_stream,
            "arrival_rate": args.arrival_rate,
            "mode": args.mode,
            "seed": args.seed,
            "train_iterations": args.train_iterations if args.checkpoints is None else 0,
        },
        "cells": [],
    }
    for directory in dirs:
        meta = read_policy_meta(directory)
        for max_slots in args.slots:
            cell = serve_cell(directory, max_slots, args, device)
            cell["system"] = meta["system"]
            cell["env"] = meta["env"]
            results["cells"].append(cell)
            lat = cell["latency"]
            console.line(
                f"{cell['system']:>10s} x {cell['env']:<14s} slots={max_slots:<3d}: "
                f"p50={lat['p50_ms']:.2f}ms p99={lat['p99_ms']:.2f}ms  "
                f"{cell['decisions_per_sec']:,.0f} decisions/s  "
                f"({cell['episodes']} episodes, mean return {cell['episode_return_mean']:.3f})"
            )

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    md_path = out.with_suffix(".md")
    with open(md_path, "w") as f:
        f.write(to_markdown(results))
    console.line(f"wrote {out} and {md_path}")
    return results


def to_markdown(results: dict) -> str:
    """Render the serving sweep as one row per (checkpoint, slot count)."""
    cfg, prov = results["config"], results["provenance"]
    lines = [
        "# Decision-serving latency/throughput (PyTorch port) — slot pool x checkpoint",
        "",
        f"{cfg['streams']} concurrent streams x {cfg['episodes_per_stream']} episodes each, "
        f"Poisson arrivals at {cfg['arrival_rate']} req/tick/stream, mode={cfg['mode']}, on "
        f"{prov['device_kind']}{', ' + prov['power_limit'] if prov.get('power_limit') else ''}. "
        "Latency is per decision (one tick advances every live slot); decisions/sec counts "
        "joint actions served.",
        "",
        "| system | env | slots | p50 (ms) | p99 (ms) | decisions/s | episodes | mean return |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for cell in results["cells"]:
        lat = cell["latency"]
        lines.append(
            f"| {cell['system']} | {cell['env']} | {cell['max_slots']} "
            f"| {lat['p50_ms']:.2f} | {lat['p99_ms']:.2f} "
            f"| {cell['decisions_per_sec']:,.0f} "
            f"| {cell['episodes']} | {cell['episode_return_mean']:.3f} |"
        )
    return "\n".join(lines) + "\n"


def main(argv=None):
    """Parse ``argv`` and serve."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
