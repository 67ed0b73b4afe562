"""Paper Fig. 6 (bottom right) on the port: time-to-reward vs number of executors.

Counterpart of the root's ``benchmarks/distribution.py``, under its row
names.  The paper scales Launchpad executor processes; here the executors
are ranks of the sharded runner (`train_distributed`), each a spawned
process training anakin on its own 8 envs, the gradients averaged across
them every update.  The reference runs in a subprocess to force XLA's
host devices; the port needs none, since `train_distributed` spawns its
own ranks.  The claim probed is *system* scaling: reward-per-env-step
parity while total throughput (env-steps/sec summed over executors)
rises with executor count.

Backends, named on each row: on a GPU, one executor is one NCCL rank and
2 and 4 executors are gloo ranks sharing the one card (NCCL refuses two
ranks on one device); on the CPU every rank is a gloo rank on ``cpu``.
The row's wall covers the whole call, the ranks' start included, as the
reference's covers its compilation; ``rank_wall`` is the slowest rank's
training loop.
"""
from __future__ import annotations

import dataclasses

from repro_torch import resolve_device
from repro_torch.bench.throughput import timed
from repro_torch.core.system import train_distributed
from repro_torch.envs import Spread
from repro_torch.systems.madqn import make_madqn
from repro_torch.systems.offpolicy import OffPolicyConfig

CFG = OffPolicyConfig(buffer_capacity=20000, min_replay=500, batch_size=64,
                      eps_decay_steps=10000)


def _system():
    """A rank's MADQN on spread, its gradients averaged over the ``"data"`` axis."""
    env = Spread(num_agents=3, horizon=25)
    return make_madqn(env, dataclasses.replace(CFG, distributed_axis="data"))


def _backend(device, n_exec: int):
    """The backend and the ranks' devices of an ``n_exec``-executor world on ``device``."""
    if device.type == "cpu":
        return "gloo", "cpu"
    if n_exec == 1:
        return "nccl", "cuda"
    return "gloo", [f"cuda:{device.index or 0}"] * n_exec


def bench(fast: bool = False, device=None):
    """The executor-scaling rows: ``(name, us_per_iteration, derived)``."""
    device = resolve_device(device)
    iters = 400 if fast else 4_000
    rows = []
    for n_exec in (1, 2, 4):
        backend, devices = _backend(device, n_exec)
        (_, metrics), dt = timed(device, lambda: train_distributed(
            _system, 0, iters, 8, n_exec, backend=backend, device=devices))
        r = float(metrics["reward"].mean())
        rank_wall = float(metrics["wall_s"].max())
        steps = iters * 8 * n_exec
        rows.append((
            f"distribution/num_executors_{n_exec}", dt / iters * 1e6,
            f"reward={r:.3f} total_env_steps/s={steps/dt:.0f} wall={dt:.1f}s "
            f"rank_wall={rank_wall:.1f}s rank_env_steps/s={steps/rank_wall:.0f} "
            f"backend={backend}",
        ))
    return rows
