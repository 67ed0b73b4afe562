"""Quickstart — the paper's Block 1 + Block 2 on the port.

Builds a system from the registry (`make_system`), runs the faithful
executor-environment loop, then the *same* system fused (anakin) with a
greedy evaluation every ``--eval-every`` iterations, then the on-policy
flagship through the same runner.  The port of ``examples/quickstart.py``;
its sizes are the reference's constants, as flags.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core.system import run_environment_loop, train_anakin
from repro_torch.envs import make_env
from repro_torch.examples import at_reference_sizes
from repro_torch.systems.registry import make_system

SIZE_FLAGS = ("iterations", "eval_every", "ippo_iterations")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iterations", type=int, default=3000)
    p.add_argument("--eval-every", type=int, default=1000)
    p.add_argument("--ippo-iterations", type=int, default=3200)
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' to run on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the three parts; returns the reward curves and the evals."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    # ---- Block 2 analogue: build the system from the registry ----
    env = make_env("matrix_game", horizon=10)
    system = make_system(
        "madqn",
        env,
        hidden_sizes=(64, 64),
        buffer_capacity=5_000,
        min_replay=100,
        batch_size=32,
        eps_decay_steps=2_000,
        learning_rate=1e-3,
    )

    # ---- Block 1 analogue: the executor-environment loop (faithful, python) ----
    print("== faithful environment loop (3 episodes) ==")
    _, _, ev = run_environment_loop(system, 0, num_episodes=3, device=device)
    loop_returns = [round(float(r), 1) for r in ev.episode_return]
    print("team episode returns:", loop_returns)

    # ---- the fused runner: same system, vectorised, greedy eval inside the run ----
    print(f"== anakin: {args.iterations} iterations x 8 envs + greedy eval every "
          f"{args.eval_every} ==")
    _, metrics, evals = train_anakin(
        system, 0, num_iterations=args.iterations, num_envs=8,
        eval_every=args.eval_every, eval_episodes=16, device=device,
    )
    r = metrics["reward"].cpu().numpy()
    eval_means = evals.episode_return.float().mean(dim=-1).cpu().numpy()
    print(f"mean reward/step: first200={r[:200].mean():.2f}  last200={r[-200:].mean():.2f}")
    print(f"greedy eval return per {args.eval_every} iters:", eval_means.round(2))
    if at_reference_sizes(args, parse_args, SIZE_FLAGS):
        assert r[-200:].mean() > r[:200].mean(), "system failed to learn"
        print("learned the climbing game.")
    else:
        print("not at the reference's sizes: the learning assertion is not made")

    # ---- the same two lines work for the on-policy flagship ----
    print("== same runner, flagship system: ippo on the same env ==")
    ippo = make_system("ippo", env, rollout_len=32, num_minibatches=2)
    _, ippo_metrics = train_anakin(ippo, 0, num_iterations=args.ippo_iterations, num_envs=8,
                                   device=device)
    ri = ippo_metrics["reward"].cpu().numpy()
    print(f"ippo reward/step: first200={ri[:200].mean():.2f}  last200={ri[-200:].mean():.2f}")
    return {"loop_returns": loop_returns, "reward": r, "eval_returns": eval_means,
            "ippo_reward": ri}


if __name__ == "__main__":
    main()
