"""SMAX-lite: a minimal SMAC-style micromanagement battle, batched over a leading env axis.

Port of `repro.envs.smax_lite`.  N allied marines (the agents) fight N
enemy marines driven by the classic SMAC heuristic (move toward and attack
the nearest living ally).  Ally actions: noop, 4 moves, then ``attack_j``
for each enemy j (SMAC's target-id action space), ``5 + N`` in all.  The
shared reward is the dense SMAC shaping: damage dealt, plus 10 a kill and
200 for the win, scaled to 20 over the best episode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import lanes
from repro_torch.envs.api import ArraySpec, DiscreteSpec, EnvSpec, agent_ids, restart, transition
from repro_torch.envs.spread import _DIRS as _MOVES


class SmaxState(NamedTuple):
    """Batched SMAX-lite state (unit positions and health)."""

    t: Any          # (N,) int32
    ally_pos: Any   # (N, A, 2)
    ally_hp: Any    # (N, A)
    enemy_pos: Any  # (N, A, 2)
    enemy_hp: Any   # (N, A)


@dataclasses.dataclass(frozen=True)
class SmaxLite:
    """SMAC-style micro-battle: N allies vs scripted enemies."""

    num_agents: int = 3
    horizon: int = 50
    max_hp: float = 45.0
    attack_range: float = 0.6
    damage: float = 6.0
    move_step: float = 0.15
    arena: float = 2.0

    def __post_init__(self):
        # one device copy of the move directions per device, made on first use
        object.__setattr__(self, "_moves_on", {})

    @property
    def agent_ids(self):
        """The tuple of agent-id strings."""
        return agent_ids(self.num_agents)

    @property
    def num_actions(self):
        """Number of discrete actions per agent: noop, 4 moves, attack each enemy."""
        return 5 + self.num_agents

    def obs_dim(self) -> int:
        """Per-agent observation length: own (pos, hp), allies and enemies (rel pos, hp)."""
        n = self.num_agents
        return 3 + (n - 1) * 3 + n * 3

    def spec(self) -> EnvSpec:
        """The env's `EnvSpec` (per-agent obs/action specs + global state)."""
        return EnvSpec(
            agent_ids=self.agent_ids,
            observations={a: ArraySpec((self.obs_dim(),)) for a in self.agent_ids},
            actions={a: DiscreteSpec(self.num_actions) for a in self.agent_ids},
            state=ArraySpec((self.num_agents * 6,)),
        )

    def _obs(self, state: SmaxState):
        n = self.num_agents
        ally_alive = (state.ally_hp > 0).float()
        enemy_alive = (state.enemy_hp > 0).float()
        ally_hp = (state.ally_hp / self.max_hp)[..., None]
        enemy_hp = (state.enemy_hp / self.max_hp)[..., None]
        out = {}
        for i, a in enumerate(self.agent_ids):
            own = state.ally_pos[:, i]
            feats = [own, ally_hp[:, i]]
            for j in range(n):
                if j != i:
                    rel = (state.ally_pos[:, j] - own) * ally_alive[:, j, None]
                    feats += [rel, ally_hp[:, j]]
            for j in range(n):
                rel = (state.enemy_pos[:, j] - own) * enemy_alive[:, j, None]
                feats += [rel, enemy_hp[:, j]]
            out[a] = torch.cat(feats, dim=-1) * ally_alive[:, i, None]
        return out

    def global_state(self, state: SmaxState):
        """Ally positions and health, then the enemies', ``(N, 6A)``."""
        n = state.ally_pos.shape[0]
        return torch.cat(
            [state.ally_pos.reshape(n, -1), state.ally_hp / self.max_hp,
             state.enemy_pos.reshape(n, -1), state.enemy_hp / self.max_hp],
            dim=-1,
        )

    def reset(self, num_envs: int, device, generator=None):
        """Start ``num_envs`` battles: allies uniform in [-1, -0.5)^2, enemies in [0.5, 1)^2."""
        n = self.num_agents
        u = lanes.rand(generator, (num_envs, 2, n, 2), device)
        full = torch.full((num_envs, n), self.max_hp, device=device)
        state = SmaxState(
            t=torch.zeros(num_envs, dtype=torch.int32, device=device),
            ally_pos=u[:, 0] * 0.5 - 1.0,
            ally_hp=full,
            enemy_pos=u[:, 1] * 0.5 + 0.5,
            enemy_hp=full.clone(),
        )
        return state, restart(self.agent_ids, self._obs(state))

    def step(self, state: SmaxState, actions):
        """Advance every battle one step: ``(state, actions) -> (state, timestep)``."""
        n = self.num_agents
        acts = torch.stack([actions[a] for a in self.agent_ids], dim=1).long()  # (N, A)
        device = acts.device
        if device not in self._moves_on:
            self._moves_on[device] = torch.tensor(_MOVES, device=device)
        ally_alive = state.ally_hp > 0
        enemy_alive = state.enemy_hp > 0

        # ally moves
        is_move = (acts < 5).float()
        delta = self._moves_on[device][acts.clamp(0, 4)] * self.move_step * is_move[..., None]
        ally_pos = torch.clamp(
            state.ally_pos + delta * ally_alive[..., None].float(), -self.arena, self.arena
        )

        # ally attacks: action 5 + j targets enemy j
        target = (acts - 5).clamp(0, n - 1)
        attacks = (acts >= 5) & ally_alive
        tpos = state.enemy_pos.gather(1, target[..., None].expand(-1, -1, 2))
        in_range = torch.linalg.vector_norm(ally_pos - tpos, dim=-1) <= self.attack_range
        hit = attacks & in_range & enemy_alive.gather(1, target)
        dmg_to_enemy = torch.zeros_like(state.enemy_hp).scatter_add_(
            1, target, self.damage * hit.float())
        enemy_hp = torch.clamp(state.enemy_hp - dmg_to_enemy, min=0.0)
        killed = (state.enemy_hp > 0) & (enemy_hp <= 0)

        # enemy heuristic: move toward / attack the nearest living ally
        d_e2a = torch.linalg.vector_norm(state.enemy_pos[:, :, None] - ally_pos[:, None], dim=-1)
        d_e2a = torch.where(ally_alive[:, None], d_e2a, 1e9)  # (N, E, A)
        nearest = torch.argmin(d_e2a, dim=-1)
        nd = d_e2a.gather(-1, nearest[..., None])[..., 0]
        can_attack = (nd <= self.attack_range) & enemy_alive
        dmg_to_ally = torch.zeros_like(state.ally_hp).scatter_add_(
            1, nearest, self.damage * can_attack.float() * (nd < 1e8).float())
        ally_hp = torch.clamp(state.ally_hp - dmg_to_ally, min=0.0)
        dir_ = ally_pos.gather(1, nearest[..., None].expand(-1, -1, 2)) - state.enemy_pos
        norm = torch.linalg.vector_norm(dir_, dim=-1, keepdim=True) + 1e-9
        enemy_pos = torch.where(
            (can_attack | ~enemy_alive)[..., None],
            state.enemy_pos,
            torch.clamp(state.enemy_pos + dir_ / norm * self.move_step, -self.arena, self.arena),
        )

        t = state.t + 1
        new_state = SmaxState(t, ally_pos, ally_hp, enemy_pos, enemy_hp)
        all_enemies_dead = (enemy_hp <= 0).all(-1)
        all_allies_dead = (ally_hp <= 0).all(-1)
        done = all_enemies_dead | all_allies_dead | (t >= self.horizon)
        # SMAC-style dense reward: damage + 10 a kill + 200 a win, scaled by the best return
        max_ret = (self.max_hp + 10.0) * n + 200.0
        r = (dmg_to_enemy.sum(-1) + 10.0 * killed.sum(-1) + 200.0 * all_enemies_dead) / max_ret
        return new_state, transition(self.agent_ids, r * 20.0, self._obs(new_state), done)
