"""Observation and stream wrappers over batched envs (port of `repro.envs.wrappers`).

* `AgentIdObs` — append a one-hot agent id to every agent's observation;
* `ConcatObsState` — global state = the concatenation of every agent's
  observation (in the registered gridworld stack, the id-augmented ones);
* `AutoReset` — fused auto-reset: an env that terminates is reset in the
  same `step`, and the returned timestep is the FIRST of the new episode
  carrying the terminal reward and discount (the merged boundary);
* `EpisodeStats` — per-agent episode returns and lengths kept in the
  state, published at every episode boundary.

Every tensor carries the leading env axis; masks of shape ``(N,)`` are
broadcast over each leaf's trailing dims.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.envs.api import ArraySpec, TimeStep
from repro_torch.tree import tree_map


def _where(mask, new, old):
    """Leafwise select along the leading env axis.

    A leaf that is not a tensor (the generator an env that draws inside
    `step` keeps in its state) is the old one: a reset hands back the
    generator it was given, which is the one the env already holds.
    """

    def sel(n, o):
        if not isinstance(o, torch.Tensor):
            return o
        return torch.where(mask.reshape(mask.shape + (1,) * (o.dim() - 1)), n, o)

    return tree_map(sel, new, old)


@dataclasses.dataclass(frozen=True)
class Wrapper:
    """Base wrapper: delegate the env protocol (and any attribute) inward."""

    env: Any

    def __getattr__(self, name):
        # only reached for attributes not defined on the wrapper itself
        return getattr(self.env, name)

    def spec(self):
        """Delegate to the inner env."""
        return self.env.spec()

    def reset(self, num_envs, device, generator=None):
        """Delegate to the inner env."""
        return self.env.reset(num_envs, device, generator)

    def step(self, state, actions):
        """Delegate to the inner env."""
        return self.env.step(state, actions)

    def global_state(self, state):
        """Delegate to the inner env."""
        return self.env.global_state(state)


# ------------------------------------------------------ observation wrappers


@dataclasses.dataclass(frozen=True)
class AgentIdObs(Wrapper):
    """Append a one-hot agent id to every agent's observation.

    Shared-weight policies on homogeneous envs can then still condition on
    which agent they act for.
    """

    def spec(self):
        """The inner spec with the one-hot id appended to each obs spec."""
        spec = self.env.spec()
        n = spec.num_agents
        obs = {
            a: ArraySpec((spec.observations[a].shape[0] + n,), spec.observations[a].dtype)
            for a in spec.agent_ids
        }
        return dataclasses.replace(spec, observations=obs)

    def __post_init__(self):
        # the one-hot ids, one copy per device and dtype, made on first use
        object.__setattr__(self, "_eye_on", {})

    def _augment(self, obs):
        ids = tuple(self.env.agent_ids)
        first = obs[ids[0]]
        key = (first.device, first.dtype)
        if key not in self._eye_on:
            self._eye_on[key] = torch.eye(len(ids), dtype=first.dtype, device=first.device)
        eye = self._eye_on[key]
        return {
            a: torch.cat([obs[a], eye[i].expand(*obs[a].shape[:-1], len(ids))], dim=-1)
            for i, a in enumerate(ids)
        }

    def _obs(self, state):
        return self._augment(self.env._obs(state))

    def reset(self, num_envs, device, generator=None):
        """Reset the inner env; augment observations with agent ids."""
        state, ts = self.env.reset(num_envs, device, generator)
        return state, ts._replace(observation=self._augment(ts.observation))

    def step(self, state, actions):
        """Step the inner env; augment observations with agent ids."""
        state, ts = self.env.step(state, actions)
        return state, ts._replace(observation=self._augment(ts.observation))


@dataclasses.dataclass(frozen=True)
class ConcatObsState(Wrapper):
    """Global state = concatenation of every agent's observation.

    The input centralised critics train on, for envs whose joint
    observations carry the full state.  Reads the inner env's
    ``_obs(state)``: under ``ConcatObsState(AgentIdObs(env))`` that is
    `AgentIdObs._obs`, so the state holds the id-augmented observations.
    """

    def spec(self):
        """The inner spec with the concat-of-observations state spec."""
        spec = self.env.spec()
        dim = sum(spec.observations[a].shape[0] for a in spec.agent_ids)
        return dataclasses.replace(spec, state=ArraySpec((dim,)))

    def global_state(self, state):
        """Every agent's observation, concatenated in agent order: ``(N, sum of dims)``."""
        obs = self.env._obs(state)
        return torch.cat([obs[a] for a in tuple(self.env.agent_ids)], dim=-1)


# ----------------------------------------------------------- stream wrappers


class AutoResetState(NamedTuple):
    """AutoReset state: the generator for auto-resets + the inner state."""

    key: Any     # torch.Generator consumed by auto-resets (or None)
    inner: Any


@dataclasses.dataclass(frozen=True)
class AutoReset(Wrapper):
    """Fused auto-reset: terminated envs restart inside the same `step`."""

    def reset(self, num_envs, device, generator=None):
        """Reset the inner env and keep ``generator`` for auto-resets."""
        inner, ts = self.env.reset(num_envs, device, generator)
        return AutoResetState(key=generator, inner=inner), ts

    def step(self, state, actions):
        """Step; where an env emits LAST, restart it and emit the merged FIRST."""
        inner, ts = self.env.step(state.inner, actions)
        n = ts.step_type.shape[0]
        reset_inner, reset_ts = self.env.reset(n, ts.step_type.device, state.key)
        done = ts.last()
        merged = TimeStep(
            step_type=torch.where(done, reset_ts.step_type, ts.step_type),
            reward=ts.reward,
            discount=ts.discount,
            observation=_where(done, reset_ts.observation, ts.observation),
        )
        return state._replace(inner=_where(done, reset_inner, inner)), merged

    def global_state(self, state):
        """Delegate to the inner env (unwrapping the AutoReset state)."""
        return self.env.global_state(state.inner)


class EpisodeStatsState(NamedTuple):
    """EpisodeStats state: running and last-completed episode statistics."""

    inner: Any
    returns: Dict[str, Any]       # running per-agent return, (N,)
    length: Any                   # (N,) int32, steps this episode
    last_returns: Dict[str, Any]  # per-agent return of the last completed episode
    last_length: Any


@dataclasses.dataclass(frozen=True)
class EpisodeStats(Wrapper):
    """Accumulate per-agent episode returns/lengths inside the env state.

    An episode completes on a raw LAST or on the merged FIRST that an
    `AutoReset` layer emits at a boundary (whose reward is the terminal one).
    """

    def reset(self, num_envs, device, generator=None):
        """Reset the inner env with zeroed episode statistics."""
        inner, ts = self.env.reset(num_envs, device, generator)
        z = {a: torch.zeros(num_envs, device=device) for a in self.env.agent_ids}
        zero_i = torch.zeros(num_envs, dtype=torch.int32, device=device)
        return EpisodeStatsState(inner, z, zero_i, dict(z), zero_i), ts

    def step(self, state, actions):
        """Step; accumulate returns/lengths, publish them at boundaries."""
        inner, ts = self.env.step(state.inner, actions)
        completed = ts.last() | ts.first()
        ret = {a: state.returns[a] + ts.reward[a] for a in state.returns}
        length = state.length + 1
        zero = torch.zeros((), device=completed.device)
        new_state = EpisodeStatsState(
            inner=inner,
            returns={a: torch.where(completed, zero, ret[a]) for a in ret},
            length=torch.where(completed, zero.to(torch.int32), length),
            last_returns={
                a: torch.where(completed, ret[a], state.last_returns[a]) for a in ret
            },
            last_length=torch.where(completed, length, state.last_length),
        )
        return new_state, ts

    def global_state(self, state):
        """Delegate to the inner env (unwrapping the stats state)."""
        return self.env.global_state(state.inner)


def replace_reset_keys(state, generator):
    """Swap the `AutoReset` generator wherever it sits in a wrapper-state stack."""
    if isinstance(state, AutoResetState):
        return state._replace(key=generator)
    if hasattr(state, "inner") and hasattr(state, "_replace"):
        return state._replace(inner=replace_reset_keys(state.inner, generator))
    raise TypeError("state stack contains no AutoReset layer")
