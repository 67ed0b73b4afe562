"""Iterated cooperative matrix games, batched over a leading env axis.

Port of `repro.envs.matrix_game`: both agents pick one of K actions, the
shared reward is ``payoff[a0, a1]``, observations are the one-hot of the
previous joint action (zeros on the first step), and an episode lasts
``horizon`` steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.envs.api import (
    ArraySpec,
    DiscreteSpec,
    EnvSpec,
    agent_ids,
    restart,
    transition,
)

CLIMBING = ((11.0, -30.0, 0.0), (-30.0, 7.0, 6.0), (0.0, 0.0, 5.0))
PENALTY = ((10.0, 0.0, -10.0), (0.0, 2.0, 0.0), (-10.0, 0.0, 10.0))


class MatrixGameState(NamedTuple):
    """Batched matrix-game state: step counts + previous joint actions."""

    t: Any            # (N,) int32
    last_joint: Any   # (N, 2) int32


@dataclasses.dataclass(frozen=True)
class MatrixGame:
    """Iterated cooperative matrix game (climbing payoff by default)."""

    payoff: tuple = CLIMBING  # (K, K) rows of floats
    horizon: int = 10

    def __post_init__(self):
        # one device copy of the payoff per device, made on first use
        object.__setattr__(self, "_payoff_on", {})

    @property
    def num_agents(self):
        """Number of agents."""
        return 2

    @property
    def agent_ids(self):
        """The tuple of agent-id strings."""
        return agent_ids(2)

    @property
    def num_actions(self):
        """Number of discrete actions per agent."""
        return len(self.payoff)

    def spec(self) -> EnvSpec:
        """The env's `EnvSpec` (per-agent obs/action specs + global state)."""
        K = self.num_actions
        obs = ArraySpec((2 * K,))
        return EnvSpec(
            agent_ids=self.agent_ids,
            observations={a: obs for a in self.agent_ids},
            actions={a: DiscreteSpec(K) for a in self.agent_ids},
            state=ArraySpec((2 * K,)),
        )

    def _payoff(self, device):
        if device not in self._payoff_on:
            self._payoff_on[device] = torch.tensor(self.payoff, device=device)
        return self._payoff_on[device]

    def global_state(self, state: MatrixGameState):
        """One-hot of the previous joint action, ``(N, 2K)`` (zeros at t = 0)."""
        K = self.num_actions
        oh = torch.nn.functional.one_hot(state.last_joint.long(), K).float()
        return oh.reshape(oh.shape[0], 2 * K) * (state.t > 0)[:, None]

    def _obs(self, state: MatrixGameState):
        oh = self.global_state(state)
        return {a: oh for a in self.agent_ids}

    def reset(self, num_envs: int, device, generator=None):
        """Start ``num_envs`` episodes; the game draws no randomness."""
        del generator
        state = MatrixGameState(
            t=torch.zeros(num_envs, dtype=torch.int32, device=device),
            last_joint=torch.zeros(num_envs, 2, dtype=torch.int32, device=device),
        )
        return state, restart(self.agent_ids, self._obs(state))

    def step(self, state: MatrixGameState, actions):
        """Advance every env one step: ``(state, actions) -> (state, timestep)``."""
        a0, a1 = actions["agent_0"], actions["agent_1"]
        r = self._payoff(a0.device)[a0.long(), a1.long()]
        t = state.t + 1
        new_state = MatrixGameState(t=t, last_joint=torch.stack([a0, a1], dim=-1))
        done = t >= self.horizon
        return new_state, transition(self.agent_ids, r, self._obs(new_state), done)
