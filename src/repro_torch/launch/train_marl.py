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
``--device``.  The reference's ``--log-every``, ``--log-dir``,
``--profile`` and ``--save-checkpoint`` flags are not ported yet.
``--continuous`` forces the env's continuous-action mode; a
continuous-control system (``maddpg``, ``mad4pg``) turns it on by itself.
"""
from __future__ import annotations

import argparse
import functools
import time

import torch

from repro_torch import resolve_device
from repro_torch.core.system import make_anakin, make_distributed, run_environment_loop
from repro_torch.core.types import TrainState
from repro_torch.distributed.impala import train_async
from repro_torch.envs import REGISTRY as ENVS
from repro_torch.eval import evaluate
from repro_torch.systems.registry import REGISTRY as SYSTEMS
from repro_torch.systems.registry import make_pair


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
    p.add_argument("--device", default=None, help="default: CUDA, raising without it")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_system(system_name, env_name, env_kwargs):
    """A sharded rank's system: gradients averaged over the ``"data"`` axis."""
    return make_pair(system_name, env_name, distributed_axis="data", env_kwargs=env_kwargs)[1]


def run(args) -> dict:
    """Launch one training run as configured; returns what it printed."""
    device = resolve_device(args.device)
    env_kwargs = {"continuous": True} if args.continuous else None
    env, system = make_pair(args.system, args.env, env_kwargs=env_kwargs)
    num_seeds = args.num_seeds if args.num_seeds > 0 else None
    if num_seeds is not None and args.runner != "anakin":
        raise ValueError("--num-seeds is an anakin option")
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
            functools.partial(_build_system, args.system, args.env, env_kwargs),
            args.iterations, args.num_envs, args.num_executors, backend=backend,
            device=device.type, eval_episodes=eval_episodes,
        )
        _sync(device)
        t0 = time.perf_counter()
        result = program(args.seed)  # the wall includes starting the ranks
        wall = time.perf_counter() - t0
        params, metrics = result[0], result[1]
        train = TrainState(params, params, (), 0)
        out = {"per_executor_reward": metrics["reward"].tolist(),
               "env_steps": args.iterations * args.num_envs * args.num_executors}
        if eval_episodes:
            returns = result[2].tolist()
            out.update(per_executor_eval_return=returns,
                       eval_return=sum(returns) / len(returns))
    elif args.runner == "async":
        if args.eval_every:
            raise ValueError("--eval-every is an anakin and sharded option")
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = train_async(system, args.seed, args.iterations, args.num_envs,
                                     args.num_actors, param_sync_every=args.param_sync_every,
                                     device=device)
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
        )
        _sync(device)
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
            print("greedy eval return (team), per eval point: "
                  f"{[round(float(x), 3) for x in ev_returns.flatten()]}")
            out["eval_return"] = float(ev_returns[..., -1].mean())
    if "eval_return" not in out:
        seeds = None if num_seeds is None else list(range(args.seed, args.seed + num_seeds))
        ev = evaluate(system, train, args.seed if seeds is None else seeds,
                      num_episodes=args.eval_episodes, num_envs=args.num_envs,
                      num_seeds=num_seeds, device=device)
        out["eval_return"] = float(ev.episode_return.mean())
    out.update(wall_s=wall, env_steps_per_s=out["env_steps"] / wall)
    print({k: v for k, v in out.items() if k not in ("wall_s", "env_steps_per_s")})
    print(f"final greedy eval return (team): {out['eval_return']:.3f}")
    print(f"wall time: {wall:.2f}s, {out['env_steps_per_s']:.0f} env steps/s "
          f"({args.system} on {args.env}, runner={args.runner}, device={device})")
    return out


def main(argv=None):
    """Parse ``argv`` and launch the run."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
