"""MPE simple-speaker-listener (Lowe et al. 2017), batched over a leading env axis.

Port of `repro.envs.speaker_listener`.  The static speaker observes the
target landmark's colour and utters one of C symbols; the listener
observes the last utterance and the landmarks relative to itself and must
move to the target.  Shared reward: minus the listener's distance to the
target.  The two agents have different observation and action specs, so
every system builds a stack per agent on this env.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import lanes
from repro_torch.envs.api import ArraySpec, DiscreteSpec, EnvSpec, restart, transition
from repro_torch.envs.spread import _DIRS


class SLState(NamedTuple):
    """Batched speaker-listener state (target, listener pose, last message)."""

    t: Any             # (N,) int32
    listener_pos: Any  # (N, 2)
    listener_vel: Any  # (N, 2)
    landmarks: Any     # (N, C, 2)
    target: Any        # (N,) int32
    last_msg: Any      # (N,) int32


def _one_hot(idx, n: int):
    return (idx[:, None] == torch.arange(n, device=idx.device)).float()


@dataclasses.dataclass(frozen=True)
class SpeakerListener:
    """Cooperative speaker-listener: the speaker signals the goal landmark."""

    num_landmarks: int = 3
    horizon: int = 25
    dt: float = 0.1
    damping: float = 0.25
    accel: float = 5.0

    def __post_init__(self):
        # one device copy of the move directions per device, made on first use
        object.__setattr__(self, "_dirs_on", {})

    @property
    def agent_ids(self):
        """The tuple of agent-id strings."""
        return ("speaker", "listener")

    def spec(self) -> EnvSpec:
        """The env's `EnvSpec` (per-agent obs/action specs + global state)."""
        C = self.num_landmarks
        return EnvSpec(
            agent_ids=self.agent_ids,
            observations={
                "speaker": ArraySpec((C,)),  # one-hot target colour
                "listener": ArraySpec((2 + 2 * C + C,)),  # vel, rel landmarks, msg one-hot
            },
            actions={"speaker": DiscreteSpec(C), "listener": DiscreteSpec(5)},
            state=ArraySpec((2 + 2 + 2 * C + C + C,)),
        )

    def _rel(self, state: SLState):
        return (state.landmarks - state.listener_pos[:, None]).flatten(1)

    def _obs(self, state: SLState):
        C = self.num_landmarks
        msg = _one_hot(state.last_msg, C)
        return {
            "speaker": _one_hot(state.target, C),
            "listener": torch.cat([state.listener_vel, self._rel(state), msg], dim=-1),
        }

    def global_state(self, state: SLState):
        """Listener pose, relative landmarks, target and message one-hots, ``(N, 4 + 4C)``."""
        C = self.num_landmarks
        return torch.cat(
            [state.listener_pos, state.listener_vel, self._rel(state),
             _one_hot(state.target, C), _one_hot(state.last_msg, C)],
            dim=-1,
        )

    def reset(self, num_envs: int, device, generator=None):
        """Start ``num_envs`` episodes: landmarks and listener uniform in [-1, 1)^2, a random target.

        One uniform draw an env: the landmarks, the listener's position,
        then the target as ``floor(u * C)``.
        """
        C = self.num_landmarks
        u = lanes.rand(generator, (num_envs, 2 * C + 3), device)
        xy = u[:, : 2 * C + 2] * 2.0 - 1.0
        state = SLState(
            t=torch.zeros(num_envs, dtype=torch.int32, device=device),
            listener_pos=xy[:, 2 * C:].contiguous(),
            listener_vel=torch.zeros(num_envs, 2, device=device),
            landmarks=xy[:, : 2 * C].reshape(num_envs, C, 2),
            target=(u[:, -1] * C).to(torch.int32).clamp_(max=C - 1),
            last_msg=torch.zeros(num_envs, dtype=torch.int32, device=device),
        )
        return state, restart(self.agent_ids, self._obs(state))

    def step(self, state: SLState, actions):
        """Advance every env one step: ``(state, actions) -> (state, timestep)``."""
        device = state.listener_pos.device
        if device not in self._dirs_on:
            self._dirs_on[device] = torch.tensor(_DIRS, device=device)
        f = self._dirs_on[device][actions["listener"].long()] * self.accel
        vel = state.listener_vel * (1.0 - self.damping) + f * self.dt
        pos = torch.clamp(state.listener_pos + vel * self.dt, -1.5, 1.5)
        t = state.t + 1
        goal = state.landmarks.gather(
            1, state.target.long()[:, None, None].expand(-1, 1, 2))[:, 0]
        r = -torch.linalg.vector_norm(pos - goal, dim=-1)
        new_state = state._replace(
            t=t, listener_pos=pos, listener_vel=vel,
            last_msg=actions["speaker"].to(torch.int32),
        )
        done = t >= self.horizon
        return new_state, transition(self.agent_ids, r, self._obs(new_state), done)
