"""Distributed on-policy training: IPPO on spread through the unified
System runners — fused anakin first, then the sharded executor scale-out
(the paper's num_executors experiment) on `torch.distributed`.

The port of ``examples/distributed_ippo.py``, whose sharded half runs on
four forced host devices.  Here the four executors are four spawned
ranks (`make_distributed`): NCCL, one card a rank, on a machine with four
cards; gloo ranks sharing ``cuda:0`` on a machine with fewer; gloo on the
CPU with ``--device cpu``.  It prints which one ran.  Its sizes are the
reference's constants, as flags.

  PYTHONPATH=src python -m repro_torch.examples.distributed_ippo [--device cpu]
"""
from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.system import make_distributed, train_anakin
from repro_torch.envs import make_env
from repro_torch.systems.registry import make_system

PPO = dict(rollout_len=64, epochs=2, num_minibatches=2)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iterations", type=int, default=120 * 64, help="anakin's iterations")
    p.add_argument("--executors", type=int, default=4)
    p.add_argument("--executor-iterations", type=int, default=1500)
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' to run on the CPU")
    return p.parse_args(argv)


def _executor_system(num_agents: int):
    """A rank's IPPO, its gradients averaged over the ``"data"`` axis (picklable)."""
    return make_system("ippo", make_env("spread", num_agents=num_agents),
                       distributed_axis="data", **PPO)


def world_for(device: torch.device, ranks: int):
    """``(backend, devices, label)``: NCCL with a card a rank where there are enough
    cards, gloo ranks sharing ``cuda:0`` where there are not, gloo on the CPU."""
    if device.type == "cpu":
        return "gloo", "cpu", f"gloo, {ranks} CPU ranks"
    if torch.cuda.device_count() >= ranks:
        return "nccl", "cuda", f"NCCL, {ranks} ranks on cuda:0..{ranks - 1}"
    return "gloo", ["cuda:0"] * ranks, (f"gloo, {ranks} ranks sharing cuda:0 "
                                        f"({torch.cuda.device_count()} card(s) here)")


def main(argv=None) -> dict:
    """Anakin, then the sharded executors; returns both runs' rewards."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    print("== IPPO (fused rollout+update, 16 envs) ==")
    env = make_env("spread", num_agents=3, horizon=25)
    system = make_system("ippo", env, **PPO)
    _, metrics = train_anakin(system, 0, args.iterations, num_envs=16, device=device)
    r = metrics["reward"].cpu().numpy()
    k = max(len(r) // 10, 1)
    print(f"reward/step: first10%={r[:k].mean():.3f} last10%={r[-k:].mean():.3f}")

    backend, devices, label = world_for(device, args.executors)
    print(f"== sharded IPPO executors ({label}) ==")
    program = make_distributed(functools.partial(_executor_system, 3),
                               args.executor_iterations, 8, args.executors,
                               backend=backend, device=devices)
    _, sharded = program(0)
    per_executor = sharded["reward"].cpu().numpy()
    print("per-executor mean reward:", np.round(per_executor, 3))
    return {"reward": r, "per_executor_reward": per_executor, "backend": backend,
            "world": label}


if __name__ == "__main__":
    main()
