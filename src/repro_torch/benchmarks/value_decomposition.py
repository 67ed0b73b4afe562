"""Paper Fig. 4 (bottom) on the port: SMAC 3v3 marines — VDN vs independent MADQN.

Counterpart of the root's ``benchmarks/value_decomposition.py``, under its
row names.  smax-lite stands in for SC2; the claim probed is the same:
additive value decomposition outperforms/matches independent learners on
the 3-marine micromanagement battle.  QMIX is included for completeness
(the paper notes its QMIX underperformed; ours is reported as measured).
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.bench.throughput import timed
from repro_torch.core.system import train_anakin
from repro_torch.envs import SmaxLite
from repro_torch.systems.madqn import make_madqn
from repro_torch.systems.offpolicy import OffPolicyConfig
from repro_torch.systems.qmix import make_qmix
from repro_torch.systems.vdn import make_vdn

CFG = OffPolicyConfig(
    buffer_capacity=50_000,
    min_replay=500,
    batch_size=64,
    eps_decay_steps=4_000,
    target_update_period=200,
    learning_rate=1e-3,
)


def bench(fast: bool = False, device=None):
    """The smax-lite rows: ``(name, us_per_iteration, derived)``."""
    device = resolve_device(device)
    env = SmaxLite(num_agents=3)
    iters = 1_000 if fast else 12_000
    n_envs = 8
    rows = []
    for maker, name in ((make_madqn, "madqn"), (make_vdn, "vdn"), (make_qmix, "qmix")):
        system = maker(env, CFG)
        (st, metrics), dt = timed(device, lambda: train_anakin(system, 0, iters, n_envs,
                                                              device=device))
        r = metrics["reward"].cpu().numpy()
        k = max(iters // 10, 1)
        rows.append(
            (
                f"smax3m/{name}",
                dt / iters * 1e6,
                f"reward_first10%={r[:k].mean():.4f} last10%={r[-k:].mean():.4f}",
            )
        )
    return rows
