"""Paper Fig. 4 (top): DIAL communication on the switch riddle.

Trains recurrent Q-agents with the differentiable channel through the
anakin runner, then the no-communication ablation, and prints the greedy
evaluator's returns (hard channel, decentralised execution: `evaluate`
thresholds the DRU).  The port of ``examples/switch_game_dial.py``.

  PYTHONPATH=src python -m repro_torch.examples.switch_game_dial [--updates 800] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core.system import train_anakin
from repro_torch.envs import SwitchGame
from repro_torch.eval import evaluate
from repro_torch.systems import DialConfig, make_dial


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--updates", type=int, default=800)
    p.add_argument("--agents", type=int, default=3)
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' to run on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train with and without the channel; returns each one's last rewards and eval return."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = SwitchGame(num_agents=args.agents)
    rollout_len = env.horizon  # one episode per env per update (DialConfig default)
    out = {}
    for use_comm in (True, False):
        name = "DIAL (learned channel)" if use_comm else "no communication"
        system = make_dial(env, DialConfig(use_comm=use_comm))
        st, metrics = train_anakin(system, 0, args.updates * rollout_len, num_envs=32,
                                   device=device)
        r = metrics["reward"].cpu().numpy().reshape(args.updates, rollout_len)
        ev = evaluate(system, st.train, 99, num_episodes=256, num_envs=64, device=device)
        ev_return = float(ev.episode_return.float().mean())
        print(f"{name:24s} train_reward/step(last 50 updates): "
              f"{r[-50:].mean():+.3f}   "
              f"eval_return (hard bits): {ev_return:+.3f}")
        out[name] = {"train_reward_last50": float(r[-50:].mean()), "eval_return": ev_return}
    return out


if __name__ == "__main__":
    main()
