"""Multi-agent environment API (port of `repro.envs.api`).

The same dm_env-style TimeStep and specs as the reference, but every env
in the port is batched natively: each tensor of a state or a TimeStep has
a leading env axis ``(N, ...)``, where the reference gets that axis from
`jax.vmap`.  Envs are frozen dataclasses of functions:

    state, ts = env.reset(num_envs, device, generator=None)
    state, ts = env.step(state, actions)     # actions: dict agent -> (N,) int32
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch


class StepType:
    """dm_env-style step-type codes (FIRST/MID/LAST)."""

    FIRST = 0
    MID = 1
    LAST = 2


class TimeStep(NamedTuple):
    """One batched multi-agent env emission."""

    step_type: Any                 # (N,) int32
    reward: Dict[str, Any]         # per-agent (N,) float32
    discount: Any                  # (N,) float32, shared
    observation: Dict[str, Any]    # per-agent (N, ...)

    def first(self):
        """True where this is the FIRST step of an episode."""
        return self.step_type == StepType.FIRST

    def last(self):
        """True where this is the LAST step of an episode."""
        return self.step_type == StepType.LAST


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Shape/dtype contract for one array-valued stream (per env)."""

    shape: Tuple[int, ...]
    dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class DiscreteSpec:
    """Spec for a discrete action with ``num_values`` choices."""

    num_values: int
    dtype: Any = torch.int32

    @property
    def shape(self):
        """Scalar: discrete actions are rank-0."""
        return ()


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Multi-agent spec: per-agent observation/action specs + global state."""

    agent_ids: Tuple[str, ...]
    observations: Dict[str, ArraySpec]
    actions: Dict[str, Any]
    state: ArraySpec

    @property
    def num_agents(self) -> int:
        """Number of agents."""
        return len(self.agent_ids)


def agent_ids(n: int) -> Tuple[str, ...]:
    """The canonical ``agent_0..agent_{n-1}`` id tuple."""
    return tuple(f"agent_{i}" for i in range(n))


def shared_reward(ids, value) -> Dict[str, Any]:
    """Broadcast one shared reward value to every agent id."""
    return {a: value for a in ids}


def restart(ids, observation) -> TimeStep:
    """The FIRST TimeStep of a batch of episodes: zero rewards, discount one."""
    obs = next(iter(observation.values()))
    n, device = obs.shape[0], obs.device
    return TimeStep(
        step_type=torch.full((n,), StepType.FIRST, dtype=torch.int32, device=device),
        reward=shared_reward(ids, torch.zeros(n, device=device)),
        discount=torch.ones(n, device=device),
        observation=observation,
    )


def transition(ids, reward, observation, done) -> TimeStep:
    """A MID/LAST TimeStep; ``reward`` is shared (N,) or a per-agent dict."""
    if not isinstance(reward, dict):
        reward = shared_reward(ids, reward)
    return TimeStep(
        step_type=torch.where(done, StepType.LAST, StepType.MID).to(torch.int32),
        reward=reward,
        discount=(~done).float(),
        observation=observation,
    )
