"""Paper Fig. 4 (top) on the port: switch riddle — communication (DIAL) vs none.

Counterpart of the root's ``benchmarks/switch_game.py``, under its row
names.  The paper's claim: adding the communication module to recurrent
MADQN lets the system solve the riddle (evaluation return -> ~1.0 with 3
agents) while the comm-less ablation plateaus near the tell-immediately
baseline.

DIAL runs through the Anakin runner (`train_anakin`) and the batched
greedy evaluator, like every other system.
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.bench.throughput import timed
from repro_torch.core.system import train_anakin
from repro_torch.envs import SwitchGame
from repro_torch.eval import evaluate
from repro_torch.systems.dial import DialConfig, make_dial


def bench(fast: bool = False, device=None):
    """The switch-game rows: ``(name, us_per_update, derived)``."""
    device = resolve_device(device)
    env = SwitchGame(num_agents=3)
    updates = 150 if fast else 2_000
    rollout_len = env.horizon  # one episode per env per update
    num_envs = 32
    rows = []
    variants = (
        ("dial", DialConfig(use_comm=True)),
        ("rial", DialConfig(use_comm=True, protocol="rial")),
        ("no_comm", DialConfig(use_comm=False)),
    )
    for name, cfg in variants:
        system = make_dial(env, cfg)
        (st, metrics), dt = timed(device, lambda: train_anakin(
            system, 0, updates * rollout_len, num_envs, device=device))
        ev = evaluate(system, st.train, 99, num_episodes=256, num_envs=64, device=device)
        ret = float(ev.episode_return.mean())
        r = metrics["reward"].cpu().numpy().reshape(updates, rollout_len)
        rows.append(
            (
                f"switch_game/{name}",
                dt / updates * 1e6,
                f"eval_return={ret:.3f} train_last50={r[-50:].mean():.3f}",
            )
        )
    return rows
