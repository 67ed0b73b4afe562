"""MPE simple-spread (Lowe et al. 2017), batched over a leading env axis.

Port of `repro.envs.spread`: N agents must cover N landmarks.  The shared
reward is minus the sum over landmarks of the distance to the closest
agent, minus a collision penalty.  Actions are discrete (5: noop / right /
left / up / down) or, with ``continuous``, 2-d forces.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import lanes
from repro_torch.envs.api import (
    ArraySpec,
    DiscreteSpec,
    EnvSpec,
    agent_ids,
    restart,
    transition,
)

_DIRS = ((0.0, 0.0), (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0))


class SpreadState(NamedTuple):
    """Batched spread state (agent positions and velocities, landmarks)."""

    t: Any          # (N,) int32
    pos: Any        # (N, A, 2)
    vel: Any        # (N, A, 2)
    landmarks: Any  # (N, A, 2)


@dataclasses.dataclass(frozen=True)
class Spread:
    """MPE simple-spread: cover all landmarks, avoid collisions."""

    num_agents: int = 3
    horizon: int = 25
    continuous: bool = False
    dt: float = 0.1
    damping: float = 0.25
    accel: float = 5.0
    collision_radius: float = 0.15

    def __post_init__(self):
        # one device copy of the move directions per device, made on first use
        object.__setattr__(self, "_dirs_on", {})

    @property
    def agent_ids(self):
        """The tuple of agent-id strings."""
        return agent_ids(self.num_agents)

    def obs_dim(self) -> int:
        """Per-agent observation length: own pos and vel, landmarks, other agents."""
        return 4 + 2 * self.num_agents + 2 * (self.num_agents - 1)

    def spec(self) -> EnvSpec:
        """The env's `EnvSpec` (per-agent obs/action specs + global state)."""
        obs = ArraySpec((self.obs_dim(),))
        act = ArraySpec((2,)) if self.continuous else DiscreteSpec(5)
        return EnvSpec(
            agent_ids=self.agent_ids,
            observations={a: obs for a in self.agent_ids},
            actions={a: act for a in self.agent_ids},
            state=ArraySpec((6 * self.num_agents,)),
        )

    def _obs(self, state: SpreadState):
        n = state.pos.shape[0]
        out = {}
        for i, a in enumerate(self.agent_ids):
            own = state.pos[:, i]
            rel_lm = (state.landmarks - own[:, None]).reshape(n, -1)
            # the other agents in their order, as the reference's jnp.delete
            # (two slices: a list index would be copied to the device, a wait)
            others = torch.cat([state.pos[:, :i], state.pos[:, i + 1 :]], dim=1)
            rel_ag = (others - own[:, None]).reshape(n, -1)
            out[a] = torch.cat([own, state.vel[:, i], rel_lm, rel_ag], dim=-1)
        return out

    def global_state(self, state: SpreadState):
        """Positions, velocities and landmarks, flattened in that order, ``(N, 6A)``."""
        n = state.pos.shape[0]
        return torch.cat(
            [state.pos.reshape(n, -1), state.vel.reshape(n, -1), state.landmarks.reshape(n, -1)],
            dim=-1,
        )

    def reset(self, num_envs: int, device, generator=None):
        """Start ``num_envs`` episodes: agents and landmarks uniform in [-1, 1)^2."""
        u = lanes.rand(generator, (num_envs, 2, self.num_agents, 2), device) * 2.0 - 1.0
        pos = u[:, 0].contiguous()
        state = SpreadState(
            t=torch.zeros(num_envs, dtype=torch.int32, device=device),
            pos=pos,
            vel=torch.zeros_like(pos),
            landmarks=u[:, 1].contiguous(),
        )
        return state, restart(self.agent_ids, self._obs(state))

    def _forces(self, actions):
        if self.continuous:
            return torch.stack([torch.clamp(actions[a], -1.0, 1.0) for a in self.agent_ids], 1)
        acts = torch.stack([actions[a] for a in self.agent_ids], 1)
        device = acts.device
        if device not in self._dirs_on:
            self._dirs_on[device] = torch.tensor(_DIRS, device=device)
        return self._dirs_on[device][acts.long()]  # (N, A, 2)

    def step(self, state: SpreadState, actions):
        """Advance every env one step: ``(state, actions) -> (state, timestep)``."""
        f = self._forces(actions) * self.accel
        vel = state.vel * (1.0 - self.damping) + f * self.dt
        pos = torch.clamp(state.pos + vel * self.dt, -1.5, 1.5)
        t = state.t + 1

        # reward: -sum_l min_a dist(l, a) - collisions
        d = torch.linalg.vector_norm(pos[:, :, None] - state.landmarks[:, None], dim=-1)
        cover = -torch.sum(torch.amin(d, dim=1), dim=-1)
        dag = torch.linalg.vector_norm(pos[:, :, None] - pos[:, None], dim=-1)
        other = ~torch.eye(self.num_agents, dtype=torch.bool, device=pos.device)
        coll = (dag < self.collision_radius) & other
        r = cover - coll.sum((1, 2)) / 2.0

        new_state = SpreadState(t=t, pos=pos, vel=vel, landmarks=state.landmarks)
        done = t >= self.horizon
        return new_state, transition(self.agent_ids, r, self._obs(new_state), done)
