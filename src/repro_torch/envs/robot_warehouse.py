"""Robot Warehouse (RWARE-lite), batched over a leading env axis.

Port of `repro.envs.robot_warehouse`.  N robots navigate a warehouse of
static shelf racks.  ``num_requests`` shelves are requested at a time: a
robot on a requested shelf's rack cell can load it (action 5), carry it to
the goal cell and deliver it there for a sparse shared team reward of +1;
the delivered shelf goes back to its rack and a fresh request replaces it.
Robots collide (contested moves are cancelled) and a loaded robot cannot
pass under an occupied rack.  Actions: 0 noop, 1..4 cardinal moves, 5
load.  Global state and agent-id features come from the wrapper stack
(`AgentIdObs` + `ConcatObsState`, see `repro_torch.envs.make_env`).

The replacement requests are drawn inside `step`, so the state keeps the
generator it was reset with (or a tuple of lane generators).  The
reference draws them in a ``lax.scan`` of categorical draws, one an agent,
each uniform over the shelves not requested at that point; here that is a
Python loop over the agents on Gumbel noise drawn in one call of
`_request_noise`, which tests replace to feed in the reference's noise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import lanes
from repro_torch.envs.api import ArraySpec, DiscreteSpec, EnvSpec, agent_ids, restart, transition
from repro_torch.envs.grid import apply_moves, hits_cells, resolve_collisions


class RwareState(NamedTuple):
    """Batched RWARE-lite state (robot cells, loads, outstanding requests)."""

    t: Any          # (N,) int32
    pos: Any        # (N, A, 2) int32 robot cells
    carrying: Any   # (N, A) int32 shelf index, -1 = unloaded
    requested: Any  # (N, S) bool
    key: Any        # the generator replacement requests are drawn from


def _request_noise(generator, num_envs: int, num_agents: int, num_shelves: int, device):
    """Gumbel noise ``(num_envs, num_agents, num_shelves)`` for one step's re-request draws."""
    u = lanes.rand(generator, (num_envs, num_agents, num_shelves), device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


@dataclasses.dataclass(frozen=True)
class RobotWarehouse:
    """RWARE-lite: robots ferry requested shelves to the goal for +1."""

    num_agents: int = 2
    grid_size: int = 8
    num_shelves: int = 8
    num_requests: int = 2
    horizon: int = 64

    def __post_init__(self):
        if self.num_requests > self.num_shelves:
            raise ValueError("num_requests cannot exceed num_shelves")
        if len(self._shelf_cells()) < self.num_shelves:
            raise ValueError(
                f"grid_size {self.grid_size} fits only "
                f"{len(self._shelf_cells())} shelves, not {self.num_shelves}"
            )
        # the static layout, one device copy per device, made on first use
        object.__setattr__(self, "_layout_on", {})

    @property
    def agent_ids(self):
        """The tuple of agent-id strings."""
        return agent_ids(self.num_agents)

    @property
    def num_actions(self):
        """Number of discrete actions per agent: noop, 4 moves, load."""
        return 6

    def _shelf_cells(self):
        """Static rack layout: shelf rows every other row, aisles around."""
        cells = [
            (r, c) for r in range(2, self.grid_size - 2, 2) for c in range(1, self.grid_size - 1)
        ]
        return cells[: self.num_shelves]

    def _goal_cell(self):
        return (self.grid_size - 1, self.grid_size // 2)

    def _free_cells(self):
        """Spawnable cells: not a rack, not the goal."""
        taken = set(self._shelf_cells()) | {self._goal_cell()}
        return [(r, c) for r in range(self.grid_size) for c in range(self.grid_size)
                if (r, c) not in taken]

    def layout(self, device):
        """``(shelf_pos (S, 2), goal_pos (2,), free cells (F, 2))``, int32 on ``device``."""
        device = torch.device(device)
        if device not in self._layout_on:
            self._layout_on[device] = tuple(
                torch.tensor(x, dtype=torch.int32, device=device)
                for x in (self._shelf_cells(), self._goal_cell(), self._free_cells())
            )
        return self._layout_on[device]

    def obs_dim(self) -> int:
        """Per-agent observation length: own pos, load, goal; per shelf rel pos,
        requested, present; the other robots' relative cells."""
        return 5 + 4 * self.num_shelves + 2 * (self.num_agents - 1)

    def spec(self) -> EnvSpec:
        """The env's `EnvSpec`; the registry's `ConcatObsState` supplies the state."""
        obs = ArraySpec((self.obs_dim(),))
        return EnvSpec(
            agent_ids=self.agent_ids,
            observations={a: obs for a in self.agent_ids},
            actions={a: DiscreteSpec(self.num_actions) for a in self.agent_ids},
            state=ArraySpec((0,)),
        )

    def _present(self, carrying):
        """Which shelves are at their rack (not loaded on a robot), ``(N, S)``."""
        shelves = torch.arange(self.num_shelves, device=carrying.device)
        return ~(carrying[:, :, None] == shelves).any(1)

    def _obs(self, state: RwareState):
        n = state.pos.shape[0]
        scale = float(self.grid_size - 1)
        shelf_pos, goal_pos, _ = self.layout(state.pos.device)
        present = self._present(state.carrying).float()
        requested = state.requested.float()
        out = {}
        for i, a in enumerate(self.agent_ids):
            own_pos = state.pos[:, i]
            loaded = (state.carrying[:, i] >= 0).float()[:, None]
            goal_rel = (goal_pos - own_pos).float() / scale
            shelf_rel = ((shelf_pos - own_pos[:, None]).float() / scale).reshape(n, -1)
            # the other robots in their order, as the reference's jnp.delete
            others = torch.cat([state.pos[:, :i], state.pos[:, i + 1:]], dim=1)
            others_rel = ((others - own_pos[:, None]).float() / scale).reshape(n, -1)
            out[a] = torch.cat(
                [own_pos.float() / scale, loaded, goal_rel, shelf_rel, requested, present,
                 others_rel], dim=-1,
            )
        return out

    def reset(self, num_envs: int, device, generator=None):
        """Start ``num_envs`` episodes: robots on distinct free cells, random requests.

        One uniform draw an env; the robots' cells and the requested
        shelves are the first of the free cells and of the shelves ordered
        by it, random permutations as the reference's draws give.
        """
        _, _, free = self.layout(device)
        F, S = free.shape[0], self.num_shelves
        u = lanes.rand(generator, (num_envs, F + S), device)
        cells = torch.argsort(u[:, :F], dim=-1, stable=True)[:, : self.num_agents]
        req = torch.argsort(u[:, F:], dim=-1, stable=True)[:, : self.num_requests]
        requested = torch.zeros(num_envs, S, dtype=torch.bool, device=device)
        state = RwareState(
            t=torch.zeros(num_envs, dtype=torch.int32, device=device),
            pos=free[cells],
            carrying=torch.full((num_envs, self.num_agents), -1, dtype=torch.int32,
                                device=device),
            requested=requested.scatter_(1, req, True),
            key=generator,
        )
        return state, restart(self.agent_ids, self._obs(state))

    def step(self, state: RwareState, actions):
        """Advance every env one step: ``(state, actions) -> (state, timestep)``."""
        acts = torch.stack([actions[a] for a in self.agent_ids], dim=1)  # (N, A)
        n, device = acts.shape[0], acts.device
        shelf_pos, goal_pos, _ = self.layout(device)
        shelves = torch.arange(self.num_shelves, device=device)
        present = self._present(state.carrying)

        # movement: loaded robots cannot pass under an occupied rack
        proposed = apply_moves(state.pos, acts, self.grid_size)
        racks = shelf_pos.expand(n, -1, -1)
        blocked = hits_cells(proposed, racks, present) & (state.carrying >= 0)
        pos = resolve_collisions(state.pos, proposed, blocked)

        # load: pick the requested, present shelf under the robot
        on_shelf = (pos[:, :, None] == shelf_pos).all(-1)  # (N, A, S)
        pickable = on_shelf & (present & state.requested)[:, None]
        can_pick = (acts == 5) & (state.carrying < 0) & pickable.any(-1)
        first = torch.argmax(pickable.to(torch.uint8), dim=-1).to(torch.int32)
        carrying = torch.where(can_pick, first, state.carrying)

        # delivery: a loaded robot on the goal cell scores (one robot fits the goal)
        deliver = (pos == goal_pos).all(-1) & (carrying >= 0)  # (N, A)
        handed_in = (shelves == carrying[:, :, None]) & deliver[:, :, None]
        requested = state.requested & ~handed_in.any(1)
        carrying = torch.where(deliver, -1, carrying)

        # replacement requests keep num_requests outstanding: one draw an
        # agent, uniform over the shelves not requested at that point
        noise = _request_noise(state.key, n, self.num_agents, self.num_shelves, device)
        for i in range(self.num_agents):
            logits = torch.where(requested, -1e9, 0.0)
            j = torch.argmax(noise[:, i] + logits, dim=-1)
            requested = requested | ((shelves == j[:, None]) & deliver[:, i, None])

        t = state.t + 1
        new_state = RwareState(t=t, pos=pos, carrying=carrying, requested=requested,
                               key=state.key)
        r = deliver.float().sum(-1)  # sparse team reward
        done = t >= self.horizon
        return new_state, transition(self.agent_ids, r, self._obs(new_state), done)
