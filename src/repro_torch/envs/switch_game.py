"""The switch riddle (Foerster et al. 2016), batched over a leading env axis.

Port of `repro.envs.switch_game`.  N prisoners; each day one (uniformly
random) is taken to the interrogation room.  Each agent acts None (0) or
Tell (1); a Tell by the agent in the room ends the episode with a shared
reward of +1 if every agent has visited the room, else -1.  Episodes last
at most ``max(4N - 6, 4)`` days.  Observations per agent are ``[in_room,
day / T]``; the switch itself is the communicating systems' message.

This env draws inside `step` (the next day's prisoner), so its state keeps
the generator it was reset with: one `torch.Generator`, or a tuple of lane
generators (`repro_torch.lanes`), whose lanes then each keep one stream.
The draw goes through `_next_prisoner`, which tests replace to feed in
the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import lanes
from repro_torch.envs.api import ArraySpec, DiscreteSpec, EnvSpec, agent_ids, restart, transition


class SwitchState(NamedTuple):
    """Batched switch-riddle state: the day, who is in the room, who has been."""

    t: Any         # (N,) int32
    in_room: Any   # (N, A) float32 one-hot: who is in the room today
    has_been: Any  # (N, A) bool
    key: Any       # the generator the step draws from (or a tuple of lane generators)


def _next_prisoner(generator, num_envs: int, num_agents: int, device):
    """The prisoner taken to the room next, one a env: ``(num_envs,)`` in ``[0, num_agents)``."""
    return lanes.randint(generator, num_agents, (num_envs,), device)


def _one_hot(idx, n: int):
    """``jax.nn.one_hot`` as float32 by comparison (``F.one_hot`` checks its range on the host)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).float()


@dataclasses.dataclass(frozen=True)
class SwitchGame:
    """Foerster's switch riddle: Tell correctly (+1) or wrongly (-1)."""

    num_agents: int = 3

    @property
    def horizon(self):
        """Episode length in steps."""
        return max(4 * self.num_agents - 6, 4)

    @property
    def agent_ids(self):
        """The tuple of agent-id strings."""
        return agent_ids(self.num_agents)

    def spec(self) -> EnvSpec:
        """The env's `EnvSpec` (per-agent obs/action specs + global state)."""
        obs = ArraySpec((2,))
        return EnvSpec(
            agent_ids=self.agent_ids,
            observations={a: obs for a in self.agent_ids},
            actions={a: DiscreteSpec(2) for a in self.agent_ids},
            state=ArraySpec((2 * self.num_agents + 1,)),
        )

    def _obs(self, state: SwitchState):
        frac = state.t.float() / self.horizon
        return {
            a: torch.stack([state.in_room[:, i], frac], dim=-1)
            for i, a in enumerate(self.agent_ids)
        }

    def global_state(self, state: SwitchState):
        """``[in_room, has_been, day / T]``, ``(N, 2A + 1)``."""
        frac = state.t.float() / self.horizon
        return torch.cat([state.in_room, state.has_been.float(), frac[:, None]], dim=-1)

    def reset(self, num_envs: int, device, generator=None):
        """Start ``num_envs`` episodes, each with a uniform first prisoner."""
        first = lanes.randint(generator, self.num_agents, (num_envs,), device)
        in_room = _one_hot(first, self.num_agents)
        state = SwitchState(
            t=torch.zeros(num_envs, dtype=torch.int32, device=device),
            in_room=in_room,
            has_been=in_room > 0,
            key=generator,
        )
        return state, restart(self.agent_ids, self._obs(state))

    def step(self, state: SwitchState, actions):
        """Advance every env one day: ``(state, actions) -> (state, timestep)``."""
        acts = torch.stack([actions[a] for a in self.agent_ids], dim=1)  # (N, A)
        # Tell only counts for the agent in the room
        tell = (acts * state.in_room.to(acts.dtype)).sum(-1) > 0
        all_visited = state.has_been.all(-1)
        reward = torch.where(tell, torch.where(all_visited, 1.0, -1.0), 0.0)

        n = acts.shape[0]
        nxt = _next_prisoner(state.key, n, self.num_agents, acts.device)
        in_room = _one_hot(nxt, self.num_agents)
        t = state.t + 1
        new_state = SwitchState(
            t=t, in_room=in_room, has_been=state.has_been | (in_room > 0), key=state.key
        )
        done = tell | (t >= self.horizon)
        return new_state, transition(self.agent_ids, reward, self._obs(new_state), done)
