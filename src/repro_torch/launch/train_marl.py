"""MARL system launcher (port of `repro.launch.train_marl`).

    PYTHONPATH=src python -m repro_torch.launch.train_marl --system ippo \\
        --env spread --runner anakin --iterations 256 --num-envs 8 --device cpu

Builds any (system, env) pair of the port's registries
(`repro_torch.systems.registry.make_pair`) and trains it with one of four
runners:

  --runner loop     the paper's Block-1 python environment loop, one env;
                    ``--iterations`` counts episodes
  --runner anakin   every env copy in one batch per iteration; with
                    ``--num-seeds N`` the runs of seeds ``--seed`` ..
                    ``--seed + N - 1`` go as seed lanes of one batch, and
                    ``--eval-every`` interleaves the greedy evaluator
  --runner sharded  ``--num-executors`` ranks on torch.distributed, each
                    running anakin on its own ``--num-envs`` envs, the
                    gradients averaged across them (gloo with
                    ``--device cpu``, else NCCL with one card a rank: more
                    executors than cards raises); ``--eval-every`` > 0
                    evaluates every executor's final params
  --runner async    IMPALA-style: ``--num-actors`` actor replicas feed a
                    trajectory queue, the learner consumes it and
                    refreshes the actors' params every
                    ``--param-sync-every`` ticks (``--iterations`` counts
                    env steps of each env of each actor and must divide
                    into the system's unroll length)

It prints the reward over the run, the greedy evaluation return, the wall
time and the env steps a second; the sharded runner also each executor's
reward (and eval return), the async runner the queue's mean depth, the
mean staleness of what the learner consumed, the dropped chunks, and the
env steps a second in all and an actor.  It runs on CUDA unless
``--device`` says otherwise, and raises when there is no GPU and no
``--device``.  ``--continuous`` forces the env's continuous-action mode;
a continuous-control system (``maddpg``, ``mad4pg``) turns it on by
itself.

Observability (`repro_torch.obs`), as the reference's:

  --log-every N      stream the metrics of every N-th iteration (iteration,
                     update count, live SPS, reward, episode return) while
                     the run goes, on every runner but loop; a pure
                     observer, the run is bitwise the same without it
  --log-dir DIR      write a run record, ``run.json`` (config, the card's
                     provenance, total/compile/steady timing, per-phase
                     timing, final metrics) with the streamed rows as
                     ``metrics.jsonl`` / ``metrics.csv``, under
                     ``DIR/<run-id>/``
  --run-id ID        the record's directory name (default: a generated id)
  --profile          a `torch.profiler` trace (``trace.json``) and the
                     op-cost summary of one anakin update cycle (the
                     iterations from a fresh state through the first
                     trainer update), in the record
  --save-checkpoint  write the trained policy as a self-describing
                     checkpoint directory (`repro_torch.serve.save_policy`;
                     a ``seed_<s>/`` lane each with ``--num-seeds``) that
                     ``repro_torch.launch.serve_marl`` restores

  PYTHONPATH=src python -m repro_torch.launch.train_marl --system rec_ippo \
      --env matrix_game --log-every 64 --log-dir results/port/runs --profile \
      --save-checkpoint results/port/ckpt/rec_ippo
"""
from __future__ import annotations

import argparse
import functools
import time

import torch

from repro_torch import resolve_device
from repro_torch.core.system import (
    _one_iteration,
    _training_env,
    init_system_state,
    make_anakin,
    make_distributed,
    run_environment_loop,
    seed_generators,
)
from repro_torch.distributed.impala import default_unroll_len, train_async
from repro_torch.envs import REGISTRY as ENVS
from repro_torch.eval import evaluate
from repro_torch.obs import (
    ConsoleSink,
    CsvSink,
    JsonlSink,
    MetricTap,
    MultiLogger,
    RetraceCounter,
    RunRecord,
    SeedAggregator,
    measure_phase_timing,
    profile_trace,
    roofline_summary,
)
from repro_torch.systems.registry import REGISTRY as SYSTEMS
from repro_torch.systems.registry import make_pair, parse_overrides


def parse_args(argv=None):
    """The launcher's command line."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--system", choices=sorted(SYSTEMS), default="ippo")
    p.add_argument("--env", choices=sorted(ENVS), default="spread")
    p.add_argument("--runner", choices=("loop", "anakin", "sharded", "async"), default="anakin")
    p.add_argument("--iterations", type=int, default=2000,
                   help="anakin, sharded, async: iterations of every env copy; loop: episodes")
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--num-executors", type=int, default=2,
                   help="sharded: ranks, one device a rank (CUDA) or processes (CPU)")
    p.add_argument("--num-actors", type=int, default=2,
                   help="async: actor replicas feeding the trajectory queue (--iterations "
                        "counts env steps per env per actor and must divide into the "
                        "system's unroll length)")
    p.add_argument("--param-sync-every", type=int, default=1,
                   help="async: refresh the actors' param snapshot every N learner ticks "
                        "(1 = every tick; staleness stays < N)")
    p.add_argument("--num-seeds", type=int, default=0,
                   help="anakin: train N seeds as lanes of one batch (0 = a single run)")
    p.add_argument("--continuous", action="store_true",
                   help="force the env's continuous-action mode (spec-checked; continuous "
                        "systems enable it automatically)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=0,
                   help="anakin: run the greedy evaluator every N iterations (0 = once, "
                        "after training)")
    p.add_argument("--eval-episodes", type=int, default=32)
    p.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE",
                   help="a config field of the system, e.g. recurrent_core=linear or "
                        "rollout_len=32 (repeatable; recorded in --save-checkpoint's metadata)")
    p.add_argument("--log-every", type=int, default=0,
                   help="stream the metrics of every N-th iteration (0 = off); a pure "
                        "observer: the run is bitwise the same with it on or off")
    p.add_argument("--log-dir", default=None,
                   help="write a run record (run.json + metrics.jsonl/csv) under "
                        "<log-dir>/<run-id>/; see docs/PORT_OBSERVABILITY.md")
    p.add_argument("--run-id", default=None,
                   help="run-record directory name (default: a generated sortable id)")
    p.add_argument("--profile", action="store_true",
                   help="a torch.profiler trace and the op-cost summary of one anakin update "
                        "cycle, in the run record (needs --log-dir)")
    p.add_argument("--save-checkpoint", default=None, metavar="DIR",
                   help="write the trained policy as a self-describing checkpoint directory "
                        "(per-seed lanes with --num-seeds) that repro_torch.serve restores")
    p.add_argument("--device", default=None, help="default: CUDA, raising without it")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_system(system_name, env_name, env_kwargs, overrides=None):
    """A sharded rank's system: gradients averaged over the ``"data"`` axis."""
    return make_pair(system_name, env_name, distributed_axis="data", env_kwargs=env_kwargs,
                     **(overrides or {}))[1]


def _update_cycle(system, seed, num_envs, num_seeds, max_iterations, device) -> int:
    """Anakin from a fresh state through its first trainer update: the profiled unit.

    Returns how many iterations that took (at most ``max_iterations``).
    """
    generator = (torch.Generator(device).manual_seed(seed) if num_seeds is None
                 else seed_generators(seed, num_seeds, device))
    tenv = _training_env(system.env)
    st = init_system_state(system, generator, num_envs, train_env=tenv)
    for it in range(max_iterations):
        st, _, upd = _one_iteration(system, tenv, st)
        if upd is not None:
            break
    return it + 1


def _profile(args, system, num_seeds, device, root) -> dict:
    """``--profile``: one update cycle under `torch.profiler`, and one under the op counter.

    The cycle (anakin from a fresh state through its first trainer update,
    `_update_cycle`) is the unit, not the whole run: a trace of every op
    of a long run is too large to write.
    """
    cycle = lambda: _update_cycle(system, args.seed, args.num_envs, num_seeds,
                                  args.iterations, device)
    with profile_trace(f"{root}/trace") as info:
        iterations = cycle()
    info["roofline"] = {**roofline_summary(cycle), "iterations": iterations}
    return info


def _open_record(args, device, console):
    """The run record and the logger the tap writes through (the console alone without one)."""
    if not args.log_dir:
        return None, console
    record = RunRecord(args.log_dir, run_id=args.run_id, config=vars(args),
                       tag=f"{args.system}-{args.env}", device=device)
    console.line(f"run record: {record.dir}")
    logger = MultiLogger(console, JsonlSink(record.metrics_path("jsonl")),
                         CsvSink(record.metrics_path("csv")))
    return record, logger


def run(args) -> dict:
    """Launch one training run as configured; returns what it printed."""
    device = resolve_device(args.device)
    env_kwargs = {"continuous": True} if args.continuous else None
    overrides = parse_overrides(args.set)
    env, system = make_pair(args.system, args.env, env_kwargs=env_kwargs, **overrides)
    num_seeds = args.num_seeds if args.num_seeds > 0 else None
    if num_seeds is not None and args.runner != "anakin":
        raise ValueError("--num-seeds is an anakin option")
    if args.profile and not args.log_dir:
        raise ValueError("--profile writes into the run record: give --log-dir too")
    console = ConsoleSink()
    record, logger = _open_record(args, device, console)
    try:
        with RetraceCounter() as rc:
            out, train, wall, tap = _train(args, system, env_kwargs, overrides, num_seeds,
                                           device, logger, console)
        if args.save_checkpoint:
            from repro_torch.serve.checkpoint import save_policy

            meta_path = save_policy(args.save_checkpoint, args.system, args.env, train,
                                    config_overrides=overrides, env_kwargs=env_kwargs,
                                    num_seeds=num_seeds, step=args.iterations)
            console.line(f"wrote policy checkpoint: {meta_path}")
            out["checkpoint"] = args.save_checkpoint
        if tap is not None:
            console.line(f"streamed {tap.emits} in-flight telemetry rows")
            out["telemetry_rows"] = tap.emits
        if record is not None:
            retrace = rc.summary()
            record.update("retrace", **retrace)
            record.update("timing", total_seconds=wall, compile_seconds=retrace["compile_seconds"],
                          steady_seconds=max(wall - retrace["compile_seconds"], 0.0))
            record.update("timing", phases=measure_phase_timing(
                system, args.num_envs, args.seed,
                eval_episodes=args.eval_episodes if args.eval_every > 0 else 0, device=device))
            record.update("metrics", **out)
            if args.profile:
                record.update("profile", **_profile(args, system, num_seeds, device, record.dir))
            out["run_record"] = str(record.save())
            console.line(f"wrote run record: {out['run_record']}")
    finally:
        logger.close()
    return out


def _train(args, system, env_kwargs, overrides, num_seeds, device, logger, console):
    """The training run itself: ``(printed metrics, final train state, wall, tap)``."""
    tap = None
    if args.log_every > 0 and args.runner != "loop":
        # the async runner's unit is a learner tick (an unroll of every env
        # of every actor), the others' one step of every env copy
        steps = (default_unroll_len(system) * args.num_envs * args.num_actors
                 if args.runner == "async" else args.num_envs * (num_seeds or 1))
        tap = MetricTap(SeedAggregator(logger) if num_seeds else logger, args.log_every,
                        steps_per_iteration=steps)
    if args.runner == "loop":
        if args.eval_every:
            raise ValueError("--eval-every is an anakin and sharded option")
        _sync(device)
        t0 = time.perf_counter()
        train, _, ev = run_environment_loop(system, args.seed, args.iterations, device=device)
        _sync(device)
        wall = time.perf_counter() - t0
        returns = ev.episode_return
        out = {
            "episode_return_first": float(returns[:3].mean()),
            "episode_return_last": float(returns[-3:].mean()),
            "env_steps": int(ev.episode_length.sum()),
        }
    elif args.runner == "sharded":
        # the device the caller asked for picks the backend: gloo on the CPU,
        # NCCL on CUDA (one card a rank; rank_devices raises with too few)
        backend = "gloo" if device.type == "cpu" else "nccl"
        eval_episodes = args.eval_episodes if args.eval_every > 0 else 0
        program = make_distributed(
            functools.partial(_build_system, args.system, args.env, env_kwargs, overrides),
            args.iterations, args.num_envs, args.num_executors, backend=backend,
            device=device.type, eval_episodes=eval_episodes, log_every=args.log_every,
            log_callback=tap,
        )
        _sync(device)
        if tap is not None:
            tap.reset_clock()
        t0 = time.perf_counter()
        result = program(args.seed)  # the wall includes starting the ranks
        wall = time.perf_counter() - t0
        # the sharded runner returns bare params: they save as a params-only
        # checkpoint (servable, not resumable), as the reference's do
        train, metrics = result[0], result[1]
        out = {"per_executor_reward": metrics["reward"].tolist(),
               "env_steps": args.iterations * args.num_envs * args.num_executors}
        if eval_episodes:
            returns = result[2].tolist()
            out.update(per_executor_eval_return=returns,
                       eval_return=sum(returns) / len(returns))
    elif args.runner == "async":
        if args.eval_every:
            raise ValueError("--eval-every is an anakin and sharded option")
        # the flag counts iterations, as for every runner; the async tap
        # counts learner ticks: at least one emission a run
        log_every_ticks = (max(1, args.log_every // default_unroll_len(system))
                           if args.log_every > 0 else 0)
        _sync(device)
        if tap is not None:
            tap.reset_clock()
        t0 = time.perf_counter()
        state, metrics = train_async(system, args.seed, args.iterations, args.num_envs,
                                     args.num_actors, param_sync_every=args.param_sync_every,
                                     device=device, log_every=log_every_ticks,
                                     log_callback=tap)
        _sync(device)
        wall = time.perf_counter() - t0
        train = state.train
        r = metrics["reward"]
        k = max(r.shape[-1] // 10, 1)
        steps = args.iterations * args.num_envs * args.num_actors
        out = {
            "reward_first10pct": float(r[:k].mean()),
            "reward_last10pct": float(r[-k:].mean()),
            "num_actors": args.num_actors,
            "param_sync_every": args.param_sync_every,
            "queue_depth_mean": float(metrics["queue_depth"].mean()),
            "staleness_mean": float(metrics["staleness"].mean()),
            "dropped_chunks": float(metrics["dropped"][-1]),
            "env_steps": steps,
            "steps_per_sec": steps / wall,
            "per_actor_steps_per_sec": steps / wall / args.num_actors,
        }
    else:
        program = make_anakin(
            system, args.iterations, args.num_envs, eval_every=args.eval_every,
            eval_episodes=args.eval_episodes, num_seeds=num_seeds, device=device,
            log_every=args.log_every, log_callback=tap,
        )
        _sync(device)
        if tap is not None:
            tap.reset_clock()
        t0 = time.perf_counter()
        result = program(args.seed)
        _sync(device)
        wall = time.perf_counter() - t0
        train, metrics = result[0].train, result[1]
        r = metrics["reward"]
        k = max(r.shape[-1] // 10, 1)
        out = {
            "reward_first10pct": float(r[..., :k].mean()),
            "reward_last10pct": float(r[..., -k:].mean()),
            "env_steps": args.iterations * args.num_envs * (num_seeds or 1),
        }
        if args.eval_every > 0:
            ev_returns = result[2].episode_return.mean(-1)  # ([S,] num_evals)
            console.line("greedy eval return (team), per eval point: "
                         f"{[round(float(x), 3) for x in ev_returns.flatten()]}")
            out["eval_return"] = float(ev_returns[..., -1].mean())
    if "eval_return" not in out:
        seeds = None if num_seeds is None else list(range(args.seed, args.seed + num_seeds))
        ev = evaluate(system, train, args.seed if seeds is None else seeds,
                      num_episodes=args.eval_episodes, num_envs=args.num_envs,
                      num_seeds=num_seeds, device=device)
        out["eval_return"] = float(ev.episode_return.mean())
    out.update(wall_s=wall, env_steps_per_s=out["env_steps"] / wall)
    console.line(str({k: v for k, v in out.items() if k not in ("wall_s", "env_steps_per_s")}))
    console.line(f"final greedy eval return (team): {out['eval_return']:.3f}")
    console.line(f"wall time: {wall:.2f}s, {out['env_steps_per_s']:.0f} env steps/s "
                 f"({args.system} on {args.env}, runner={args.runner}, device={device})")
    return out, train, wall, tap


def main(argv=None):
    """Parse ``argv`` and launch the run."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
