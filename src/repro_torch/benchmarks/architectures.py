"""Paper Fig. 6 on the port: MAD4PG/MADDPG across architectures on MPE tasks.

Counterpart of the root's ``benchmarks/architectures.py``, under its row
names.  Decentralised vs centralised critics on continuous-action spread,
plus the speaker-listener sanity run (discrete, via MAPPO as the modern
stand-in for the paper's feedforward actor-critic on that task).
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.bench.throughput import timed
from repro_torch.core.architectures import DecentralisedPolicyActor
from repro_torch.core.system import train_anakin
from repro_torch.envs import SpeakerListener, Spread
from repro_torch.systems.maddpg import MaddpgConfig, make_mad4pg, make_maddpg
from repro_torch.systems.onpolicy import PPOConfig, make_mappo

CFG = MaddpgConfig()  # the reference's recipe: batch 512, critic_lr 3e-3


def bench(fast: bool = False, device=None):
    """The architecture rows: ``(name, us_per_iteration_or_update, derived)``."""
    device = resolve_device(device)
    iters = 800 if fast else 30_000
    n_envs = 8
    rows = []
    env = Spread(num_agents=3, horizon=25, continuous=True)
    runs = [
        ("spread/maddpg_centralised", make_maddpg, None),
        ("spread/mad4pg_centralised", make_mad4pg, None),
        (
            "spread/mad4pg_decentralised",
            make_mad4pg,
            DecentralisedPolicyActor(),
        ),
    ]
    for name, maker, arch in runs:
        system = maker(env, CFG, architecture=arch)
        (st, metrics), dt = timed(device, lambda: train_anakin(system, 0, iters, n_envs,
                                                              device=device))
        r = metrics["reward"].cpu().numpy()
        k = max(iters // 10, 1)
        rows.append(
            (
                name,
                dt / iters * 1e6,
                f"reward_first10%={r[:k].mean():.3f} last10%={r[-k:].mean():.3f}",
            )
        )

    # speaker-listener with MAPPO (asymmetric agents need per-agent nets),
    # through the same Anakin runner as the off-policy systems
    sl = SpeakerListener()
    rollout_len = 64
    ppo = make_mappo(sl, PPOConfig(rollout_len=rollout_len, shared_weights=False))
    updates = 30 if fast else 400
    (st, metrics), dt = timed(device, lambda: train_anakin(ppo, 0, updates * rollout_len, 16,
                                                          device=device))
    r = metrics["reward"].cpu().numpy()
    k = max(len(r) // 10, 1)
    rows.append(
        (
            "speaker_listener/mappo",
            dt / updates * 1e6,
            f"reward_first10%={r[:k].mean():.3f} last10%={r[-k:].mean():.3f}",
        )
    )
    return rows
