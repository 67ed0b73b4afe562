"""Training throughput across the runner rungs (port of `repro.bench.throughput`).

Each (system, env) cell reports environment steps per second for

  * ``python_loop`` — the paper's Block-1 loop (`run_environment_loop`:
    one env, python-paced), timed after a one-episode warm-up call;
  * ``anakin``      — `make_anakin`'s program (every env copy in one
    batch an iteration), best of 3 calls after a warm one;
  * ``shard_map``   — the sharded runner (`make_distributed`): one rank a
    CUDA device on NCCL (``torch.cuda.device_count()`` ranks), or one
    gloo rank on the CPU.  Every call spawns fresh ranks, so no warm call
    survives between calls: the rate is read from the ranks' own training
    loops (``metrics["wall_s"]``), each run after a warm-up run of the
    same program, and the call's wall (process start, CUDA context, NCCL
    set-up, kernel loads) is kept beside it as ``call_wall_seconds``;

plus ``seed_vectorization``: N seeds trained one after another (one
program called with each seed) against the same N seeds as lanes of one
batch (``make_anakin(..., num_seeds=N)``, `repro_torch.lanes`; the
reference vmaps them).  The document keeps the reference's keys, so
``vmapped_steps_per_sec`` is the lanes' rate.

Recurrent cells also report ``fused_recurrent``: the same anakin program
with the memory core switched from the reference GRU to the linear core
(``recurrent_core="linear"``), whose unrolls run the hand-written
``recurrent_scan`` kernel on the card.  Every cell reports
``async_actors``: the async actor/learner runner
(`repro_torch.distributed.impala.make_async`) at 1/2/4 actors.

The runners return before the device has finished (nothing waits inside
their loops), so every timing starts from a synchronised device and ends
with ``torch.cuda.synchronize``.  Each best-of rung keeps its timed
repeats (``repeat_seconds``) beside the best.  Steps/sec counts
environment steps summed over envs, ranks, lanes and actors.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.system import make_anakin, make_distributed, run_environment_loop
from repro_torch.distributed.impala import make_async
from repro_torch.obs import ConsoleSink, provenance
from repro_torch.systems.registry import (
    REGISTRY,
    SMOKE_OVERRIDES,
    compatibility,
    make_pair,
    smoke_overrides,
)
from repro_torch.tree import tree_leaves

__all__ = [
    "DEFAULT_OUT",
    "SMOKE_OVERRIDES",
    "bench_cell",
    "measure_anakin",
    "measure_async_actors",
    "measure_fused_recurrent",
    "measure_python_loop",
    "measure_seed_vectorization",
    "measure_shard_map",
    "run_bench",
    "smoke_overrides",
    "timed",
    "to_markdown",
]

# the port's artifacts go under results/port/, never into the root's
# BENCH_speed.json, which is the JAX package's
DEFAULT_OUT = "results/port/BENCH_speed.json"

# the bench harness's human-facing reporting path (see repro_torch.obs.sinks)
_console = ConsoleSink()

_REPEATS = 3  # timed repetitions; best-of is reported (noise floor, not mean)


def timed(device, fn):
    """``(fn(), its wall in seconds)``, from a synchronised device to the call's last op."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _timed_warm(program, *args, device, repeats: int = _REPEATS) -> list:
    """The walls of ``repeats`` calls of ``program(*args)`` after a discarded warm call.

    The first call pays the first-use costs (the kernel's build and load,
    cuBLAS handles, the allocator's growth); best-of suppresses scheduler
    noise, which on a shared host exceeds the effects measured.
    """
    program(*args)
    return [timed(device, lambda: program(*args))[1] for _ in range(repeats)]


def _best(steps: int, walls: list) -> Dict:
    """A best-of rung: the rate of the fastest repeat, every repeat kept."""
    best = min(walls)
    return {"steps_per_sec": steps / best, "env_steps": steps, "wall_seconds": best,
            "repeat_seconds": walls}


def measure_python_loop(system, num_episodes: int = 3, seed: int = 0, device=None) -> Dict:
    """Steps/sec of the faithful Block-1 python loop.

    A one-episode warm-up call pays the first-use costs first, so the
    timed number is the loop's steady state: python-paced launches of the
    batch-of-one ops, with a host read of the step type every step.
    """
    device = resolve_device(device)
    run_environment_loop(system, seed, num_episodes=1, device=device)
    (_, _, ev), dt = timed(device, lambda: run_environment_loop(
        system, seed, num_episodes=num_episodes, device=device))
    steps = int(ev.episode_length.sum())
    return {"steps_per_sec": steps / dt, "env_steps": steps, "wall_seconds": dt}


def measure_anakin(system, iterations: int, num_envs: int, seed: int = 0, device=None) -> Dict:
    """Steps/sec of the Anakin program (warm, best of 3)."""
    device = resolve_device(device)
    program = make_anakin(system, iterations, num_envs, device=device)
    return _best(iterations * num_envs, _timed_warm(program, seed, device=device))


def _distributed_system(system_name: str, env_name: str, overrides: dict):
    """A sharded rank's system: gradients averaged over the ``"data"`` axis (pickles by name)."""
    return make_pair(system_name, env_name, distributed_axis="data", **overrides)[1]


def measure_shard_map(system_fn, iterations: int, num_envs_per_device: int, seed: int = 0,
                      device=None) -> Dict:
    """Steps/sec of the sharded runner over every local device.

    ``system_fn`` builds the system with ``distributed_axis="data"`` and
    pickles (every rank is a spawned process that builds its own).  On
    CUDA the world is one NCCL rank a card, on the CPU one gloo rank.
    The rate is the ranks' warm training loops' (the slowest rank's
    wall); ``call_wall_seconds`` is the whole call, spawning included.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        backend, num_ranks = "nccl", torch.cuda.device_count()
    else:
        backend, num_ranks = "gloo", 1
    program = make_distributed(system_fn, iterations, num_envs_per_device, num_ranks,
                               backend=backend, device=device.type, warmup=True)
    t0 = time.perf_counter()
    _, metrics = program(seed)
    call_wall = time.perf_counter() - t0
    rank_walls = [float(w) for w in metrics["wall_s"]]
    wall = max(rank_walls)
    steps = iterations * num_envs_per_device * num_ranks
    return {
        "steps_per_sec": steps / wall,
        "env_steps": steps,
        "wall_seconds": wall,
        "num_devices": num_ranks,
        "backend": backend,
        "rank_wall_seconds": rank_walls,
        "call_wall_seconds": call_wall,
    }


def _seed_sides(system, num_seeds: int, iterations: int, num_envs: int, device):
    """The two sides of the seed rung, each a call returning the final train state(s).

    ``serial()`` runs seeds ``0 .. N-1`` one after another through one
    program (a list of train states); ``lanes()`` runs the same seeds as
    lanes of one batch (one train state with a leading ``(N,)`` axis).
    """
    seeds = list(range(num_seeds))
    one = make_anakin(system, iterations, num_envs, device=device)
    batched = make_anakin(system, iterations, num_envs, num_seeds=num_seeds, device=device)
    return (lambda: [one(s)[0].train for s in seeds]), (lambda: batched(seeds)[0].train)


def measure_seed_vectorization(system, num_seeds: int, iterations: int, num_envs: int,
                               device=None) -> Dict:
    """Serial-vs-lanes multi-seed training speedup (the headline column).

    Both sides train seeds ``0 .. N-1`` for the same iteration budget, each
    side warm (its first call discarded) and best of 3, so the ratio
    isolates what batching the seeds into one set of launches buys.
    """
    device = resolve_device(device)
    serial, lanes = _seed_sides(system, num_seeds, iterations, num_envs, device)
    serial_walls = _timed_warm(serial, device=device)
    lanes_walls = _timed_warm(lanes, device=device)
    steps = num_seeds * iterations * num_envs
    return {
        "num_seeds": num_seeds,
        "serial_steps_per_sec": steps / min(serial_walls),
        "vmapped_steps_per_sec": steps / min(lanes_walls),
        "speedup": min(serial_walls) / min(lanes_walls),
        "serial_repeat_seconds": serial_walls,
        "lanes_repeat_seconds": lanes_walls,
    }


def measure_fused_recurrent(system_name: str, env_name: str, iterations: int, num_envs: int,
                            reference_steps_per_sec: float, overrides: dict,
                            device=None) -> Dict:
    """Linear-core anakin throughput vs the GRU reference core.

    Rebuilds the same (system, env) cell at the same operating point with
    ``recurrent_core="linear"`` and times the same anakin program, so the
    ratio isolates the memory-core swap (the gates from one batched
    projection and the whole window through ``recurrent_scan`` vs a
    sequential per-step GRU).  ``reference_steps_per_sec`` is the cell's
    already-measured default-core anakin number.
    """
    _, fused_system = make_pair(system_name, env_name,
                                **{**overrides, "recurrent_core": "linear"})
    fused = measure_anakin(fused_system, iterations, num_envs, device=device)
    return {
        "core": "linear",
        "reference_core": "gru",
        "reference_steps_per_sec": reference_steps_per_sec,
        "fused_steps_per_sec": fused["steps_per_sec"],
        "speedup": fused["steps_per_sec"] / reference_steps_per_sec,
        "repeat_seconds": fused["repeat_seconds"],
    }


def measure_async_actors(system_name: str, env_name: str, iterations: int, num_envs: int,
                         overrides: dict, actor_counts: Sequence[int] = (1, 2, 4),
                         param_sync_every: int = 1, device=None) -> Dict:
    """Async actor/learner throughput scaling with actor count.

    One row per actor count: the same (system, env) cell trained by
    `repro_torch.distributed.impala.make_async` with N actors (lanes of
    one batch) feeding the trajectory queue.  ``iterations`` counts env
    steps per env *per actor* (anakin's unit), so total env steps grow
    with N.  On-policy systems run with ``use_vtrace=True`` (the
    correction the async runner needs whenever staleness > 0), so the rung
    measures the production configuration.
    """
    device = resolve_device(device)
    entry = REGISTRY[system_name]
    has_vtrace = "use_vtrace" in {f.name for f in dataclasses.fields(entry.config_cls)}
    ov = {**overrides, "use_vtrace": True} if has_vtrace else dict(overrides)
    _, system = make_pair(system_name, env_name, **ov)
    rows = []
    unroll = None
    for num_actors in actor_counts:
        program = make_async(system, iterations, num_envs, num_actors,
                             param_sync_every=param_sync_every, device=device)
        unroll = program.unroll_len
        steps = iterations * num_envs * num_actors
        rows.append({"num_actors": int(num_actors),
                     **_best(steps, _timed_warm(program, 0, device=device))})
    return {
        "actor_counts": [int(a) for a in actor_counts],
        "param_sync_every": int(param_sync_every),
        "unroll_len": int(unroll),
        "use_vtrace": has_vtrace,
        "cells": rows,
    }


def bench_cell(system_name: str, env_name: str, iterations: int, num_envs: int,
               num_seeds: int, loop_episodes: int, system_overrides: Optional[dict] = None,
               device=None) -> Dict:
    """One BENCH_speed cell: every runner rung + the seed-vectorization row."""
    reason = compatibility(system_name, env_name)
    if reason is not None:
        return {"system": system_name, "env": env_name, "compatible": False, "reason": reason}
    device = resolve_device(device)
    overrides = (smoke_overrides(system_name) if system_overrides is None
                 else dict(system_overrides))
    env, system = make_pair(system_name, env_name, **overrides)
    loop = measure_python_loop(system, loop_episodes, device=device)
    anakin = measure_anakin(system, iterations, num_envs, device=device)
    sharded = measure_shard_map(
        functools.partial(_distributed_system, system_name, env_name, overrides),
        iterations, num_envs, device=device)
    anakin["speedup_vs_loop"] = anakin["steps_per_sec"] / loop["steps_per_sec"]
    sharded["speedup_vs_loop"] = sharded["steps_per_sec"] / loop["steps_per_sec"]
    # the fused-recurrent rung applies where the system (a) exposes the
    # memory-core selector and (b) actually threads memory (ff systems
    # share PPOConfig but carry an empty tree); the carry is built on the
    # meta device, which allocates nothing
    entry = REGISTRY[system_name]
    has_core_field = "recurrent_core" in {f.name for f in dataclasses.fields(entry.config_cls)}
    is_recurrent = bool(tree_leaves(system.initial_carry((), "meta")))
    fused = (
        measure_fused_recurrent(system_name, env_name, iterations, num_envs,
                                anakin["steps_per_sec"], overrides, device=device)
        if has_core_field and is_recurrent
        else None
    )
    return {
        "system": system_name,
        "env": env_name,
        "compatible": True,
        "horizon": int(env.horizon),
        "config_overrides": {k: list(v) if isinstance(v, tuple) else v
                             for k, v in overrides.items()},
        "runners": {"python_loop": loop, "anakin": anakin, "shard_map": sharded},
        "seed_vectorization": measure_seed_vectorization(system, num_seeds, iterations,
                                                         num_envs, device=device),
        **({"fused_recurrent": fused} if fused is not None else {}),
        "async_actors": measure_async_actors(system_name, env_name, iterations, num_envs,
                                             overrides, device=device),
    }


def run_bench(system_names: Sequence[str], env_names: Sequence[str], iterations: int = 256,
              num_envs: int = 4, num_seeds: int = 8, loop_episodes: int = 3,
              out_path: str = DEFAULT_OUT, system_overrides: Optional[dict] = None,
              device=None) -> Dict:
    """Sweep systems x envs for throughput; write BENCH_speed.json + .md.

    Systems run at the `SMOKE_OVERRIDES` operating point unless
    ``system_overrides`` maps their name to an explicit config dict (``{}``
    for the registry's defaults).  The document has the reference's keys
    (docs/BENCH.md; the port's differences in docs/PORT_BENCH.md) and is
    validated by `repro_torch.bench.schema.check_speed_schema`
    (``scripts/check_port_bench_schema.py``).  ``device`` defaults to
    CUDA and raises when there is none.
    """
    device = resolve_device(device)
    overrides = system_overrides or {}
    results: Dict = {
        "framework": "torch",
        "provenance": provenance(device),
        "config": {
            "iterations": iterations,
            "num_envs": num_envs,
            "num_seeds": num_seeds,
            "loop_episodes": loop_episodes,
            "backend": device.type,
            "num_devices": torch.cuda.device_count() if device.type == "cuda" else 1,
        },
        "cells": [],
    }
    for sys_name in system_names:
        for env_name in env_names:
            t0 = time.perf_counter()
            cell = bench_cell(sys_name, env_name, iterations, num_envs, num_seeds,
                              loop_episodes, system_overrides=overrides.get(sys_name),
                              device=device)
            results["cells"].append(cell)
            if not cell["compatible"]:
                _console.line(f"{sys_name:>10s} x {env_name:<18s}: skipped ({cell['reason']})")
                continue
            sv = cell["seed_vectorization"]
            fr = cell.get("fused_recurrent")
            fused_note = f"fused core={fr['speedup']:.1f}x  " if fr else ""
            aa = cell["async_actors"]
            async_note = "async " + "/".join(
                f"{row['steps_per_sec']:,.0f}" for row in aa["cells"]
            ) + f" @ {aa['actor_counts']} actors  "
            _console.line(
                f"{sys_name:>10s} x {env_name:<18s}: "
                f"loop={cell['runners']['python_loop']['steps_per_sec']:,.0f} "
                f"anakin={cell['runners']['anakin']['steps_per_sec']:,.0f} "
                f"shard_map={cell['runners']['shard_map']['steps_per_sec']:,.0f} steps/s  "
                f"{sv['num_seeds']}-seed lanes speedup={sv['speedup']:.1f}x  "
                f"{fused_note}"
                f"{async_note}"
                f"({time.perf_counter() - t0:.1f}s)"
            )

    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    md_path = out.with_suffix(".md")
    with open(md_path, "w") as f:
        f.write(to_markdown(results))
    _console.line(f"wrote {out} and {md_path}")
    return results


def to_markdown(results: Dict) -> str:
    """Render the throughput sweep as one row per cell (the reference's rows)."""
    cfg = results["config"]
    lines = [
        "# Training throughput — runners x seed lanes (the PyTorch port)",
        "",
        f"{cfg['iterations']} iterations x {cfg['num_envs']} envs per run, "
        f"{cfg['num_seeds']} seeds, backend={cfg['backend']} "
        f"({cfg['num_devices']} device(s)). Steps/sec counts environment "
        "steps over all envs/ranks/seeds; `lanes speedup` is serial "
        "per-seed training vs the seeds as lanes of one batch (the "
        "reference's `vmap speedup`); `fused core` is anakin with the "
        "linear memory core (the recurrent_scan kernel on the card) vs the "
        "reference GRU (recurrent systems only); `async actors` is the "
        "async actor/learner runner's steps/sec at 1/2/4 actors; "
        "`shard_map` is the sharded runner's warm rank loop "
        "(docs/PORT_BENCH.md).",
        "",
        "| system | env | python loop (steps/s) | anakin (steps/s) | "
        "shard_map (steps/s) | lanes speedup | fused core | async actors |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for cell in results["cells"]:
        if not cell.get("compatible"):
            lines.append(
                f"| {cell['system']} | {cell['env']} | -- | -- | -- | -- | -- "
                "| -- |"
            )
            continue
        r, sv = cell["runners"], cell["seed_vectorization"]
        fr = cell.get("fused_recurrent")
        fused_col = (
            f"{fr['fused_steps_per_sec']:,.0f} ({fr['speedup']:.1f}x)"
            if fr else "--"
        )
        aa = cell.get("async_actors")
        async_col = (
            " / ".join(f"{row['steps_per_sec']:,.0f}" for row in aa["cells"])
            + f" @ {'/'.join(str(a) for a in aa['actor_counts'])}"
            if aa else "--"
        )
        lines.append(
            f"| {cell['system']} | {cell['env']} "
            f"| {r['python_loop']['steps_per_sec']:,.0f} "
            f"| {r['anakin']['steps_per_sec']:,.0f} "
            f"({r['anakin']['speedup_vs_loop']:.0f}x) "
            f"| {r['shard_map']['steps_per_sec']:,.0f} "
            f"| {sv['speedup']:.1f}x @ {sv['num_seeds']} seeds "
            f"| {fused_col} "
            f"| {async_col} |"
        )
    return "\n".join(lines) + "\n"
