"""Paper Fig. 4 (bottom): value decomposition on a 3-marine battle.

VDN against independent MADQN on smax-lite (the offline stand-in for SMAC
3m).  The port of ``examples/smax_vdn.py``.

  PYTHONPATH=src python -m repro_torch.examples.smax_vdn [--iters 12000] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core.system import train_anakin
from repro_torch.envs import SmaxLite
from repro_torch.systems import OffPolicyConfig, make_madqn, make_vdn


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=12000)
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' to run on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train both systems; returns each one's reward curve."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = SmaxLite(num_agents=3)
    cfg = OffPolicyConfig(
        buffer_capacity=50_000, min_replay=500, batch_size=64,
        eps_decay_steps=4_000, target_update_period=200, learning_rate=1e-3,
    )
    out = {}
    for maker, name in ((make_madqn, "independent MADQN"), (make_vdn, "VDN")):
        system = maker(env, cfg)
        _, metrics = train_anakin(system, 0, args.iters, num_envs=8, device=device)
        r = metrics["reward"].cpu().numpy()
        k = max(args.iters // 10, 1)
        print(f"{name:18s} reward/step first10%={r[:k].mean():.4f} "
              f"last10%={r[-k:].mean():.4f}")
        out[name] = r
    return out


if __name__ == "__main__":
    main()
