"""Level-Based Foraging (Albrecht & Ramamoorthy), batched over a leading env axis.

Port of `repro.envs.lbf`.  N leveled agents forage F leveled foods on a
grid.  Agents adjacent to a food that choose ``load`` collect it iff the
sum of their levels reaches the food's level.  With ``shared_reward``
every agent receives the team mean; otherwise each participating agent is
paid its level-proportional share of the food's level, normalised by the
total food level.  Actions: 0 noop, 1..4 cardinal moves, 5 load.  Episodes
end when every food is collected or at ``horizon``.  Global state and
agent-id features come from the wrapper stack (`AgentIdObs` +
`ConcatObsState`, see `repro_torch.envs.make_env`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import lanes
from repro_torch.envs.api import ArraySpec, DiscreteSpec, EnvSpec, agent_ids, restart, transition
from repro_torch.envs.grid import (
    apply_moves,
    hits_cells,
    resolve_collisions,
    sample_distinct_cells,
)


class LbfState(NamedTuple):
    """Batched Level-Based Foraging state (positions, levels, food)."""

    t: Any            # (N,) int32
    pos: Any          # (N, A, 2) int32
    levels: Any       # (N, A) int32 agent levels (fixed for the episode)
    food_pos: Any     # (N, F, 2) int32
    food_level: Any   # (N, F) int32
    food_active: Any  # (N, F) bool


@dataclasses.dataclass(frozen=True)
class LevelBasedForaging:
    """Level-Based Foraging: leveled agents pool to collect leveled food."""

    num_agents: int = 2
    grid_size: int = 8
    num_food: int = 3
    max_level: int = 2
    horizon: int = 32
    shared_reward: bool = False

    def __post_init__(self):
        if self.num_agents + self.num_food > self.grid_size**2:
            raise ValueError("grid too small for agents + food")

    @property
    def agent_ids(self):
        """The tuple of agent-id strings."""
        return agent_ids(self.num_agents)

    @property
    def num_actions(self):
        """Number of discrete actions per agent: noop, 4 moves, load."""
        return 6

    def obs_dim(self) -> int:
        """Per-agent observation length: own pos and level, foods, other agents."""
        return 3 + 4 * self.num_food + 3 * (self.num_agents - 1)

    def spec(self) -> EnvSpec:
        """The env's `EnvSpec`; the registry's `ConcatObsState` supplies the state."""
        obs = ArraySpec((self.obs_dim(),))
        return EnvSpec(
            agent_ids=self.agent_ids,
            observations={a: obs for a in self.agent_ids},
            actions={a: DiscreteSpec(self.num_actions) for a in self.agent_ids},
            state=ArraySpec((0,)),
        )

    def _obs(self, state: LbfState):
        n = state.pos.shape[0]
        scale = float(self.grid_size - 1)
        lvl_scale = float(self.num_agents * self.max_level)
        food_lvl = state.food_level.float() / lvl_scale
        food_active = state.food_active.float()
        out = {}
        for i, a in enumerate(self.agent_ids):
            own_pos = state.pos[:, i]
            own = own_pos.float() / scale
            own_lvl = (state.levels[:, i].float() / self.max_level)[:, None]
            food_rel = ((state.food_pos - own_pos[:, None]).float() / scale).reshape(n, -1)
            # the other agents in their order, as the reference's jnp.delete
            # (two slices: a list index would be copied to the device, a wait)
            other_pos = torch.cat([state.pos[:, :i], state.pos[:, i + 1 :]], dim=1)
            rel = ((other_pos - own_pos[:, None]).float() / scale).reshape(n, -1)
            other_lvl = torch.cat([state.levels[:, :i], state.levels[:, i + 1 :]], dim=1)
            other_lvl = other_lvl.float() / self.max_level
            out[a] = torch.cat(
                [own, own_lvl, food_rel, food_lvl, food_active, rel, other_lvl], dim=-1
            )
        return out

    def reset(self, num_envs: int, device, generator=None):
        """Start ``num_envs`` episodes on distinct cells with random levels.

        One uniform draw an env: the cell order, the agent levels in
        ``[1, max_level]``, then food levels in ``[1, sum(levels)]`` (each
        food collectible by the whole team), whose upper bound differs per
        env, so each is ``lo + floor(u * (hi - lo))``.
        """
        A, F, cells = self.num_agents, self.num_food, self.grid_size**2
        u = lanes.rand(generator, (num_envs, cells + A + F), device)
        pos = sample_distinct_cells(u[:, :cells], self.grid_size, A + F)
        levels = 1 + torch.floor(u[:, cells : cells + A] * self.max_level).to(torch.int32)
        team = levels.sum(-1, keepdim=True, dtype=torch.int32)
        food_level = 1 + torch.floor(u[:, cells + A :] * team).to(torch.int32)
        state = LbfState(
            t=torch.zeros(num_envs, dtype=torch.int32, device=device),
            pos=pos[:, :A].contiguous(),
            levels=levels,
            food_pos=pos[:, A:].contiguous(),
            food_level=food_level,
            food_active=torch.ones(num_envs, F, dtype=torch.bool, device=device),
        )
        return state, restart(self.agent_ids, self._obs(state))

    def step(self, state: LbfState, actions):
        """Advance every env one step: ``(state, actions) -> (state, timestep)``."""
        acts = torch.stack([actions[a] for a in self.agent_ids], dim=1)  # (N, A)

        # movement: food cells are solid
        proposed = apply_moves(state.pos, acts, self.grid_size)
        blocked = hits_cells(proposed, state.food_pos, state.food_active)
        pos = resolve_collisions(state.pos, proposed, blocked)

        # loading: adjacent loaders pool their levels per food
        adjacent = (pos[:, :, None] - state.food_pos[:, None]).abs().sum(-1) == 1  # (N, A, F)
        loading = (acts == 5)[:, :, None] & adjacent & state.food_active[:, None, :]
        pooled = (state.levels[:, :, None] * loading).sum(1, dtype=torch.int32)  # (N, F)
        collected = state.food_active & (pooled >= state.food_level) & (pooled > 0)

        # level-proportional shares, normalised by the total food level
        total_level = state.food_level.sum(-1, dtype=torch.int32).float()
        share = (loading * state.levels[:, :, None].float()) / torch.clamp(
            pooled, min=1
        )[:, None, :].float()
        gains = (collected * state.food_level).float()
        r_agents = (share * gains[:, None, :]).sum(-1) / total_level[:, None]  # (N, A)
        if self.shared_reward:
            r_agents = r_agents.mean(-1, keepdim=True).expand_as(r_agents)
        reward = {a: r_agents[:, i] for i, a in enumerate(self.agent_ids)}

        food_active = state.food_active & ~collected
        t = state.t + 1
        new_state = state._replace(t=t, pos=pos, food_active=food_active)
        done = (t >= self.horizon) | ~food_active.any(-1)
        return new_state, transition(self.agent_ids, reward, self._obs(new_state), done)
