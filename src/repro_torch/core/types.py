"""Core MARL types (port of `repro.core.types`), with the same fields."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple


class Transition(NamedTuple):
    """One multi-agent transition row; ``extras`` is the executor's side channel."""

    obs: Dict[str, Any]
    actions: Dict[str, Any]
    rewards: Dict[str, Any]
    discount: Any
    next_obs: Dict[str, Any]
    state: Any
    next_state: Any
    extras: Dict[str, Any] = {}
    step_type: Any = ()


class Carry(NamedTuple):
    """Typed executor memory: memory-core state and outgoing messages."""

    hidden: Any
    message: Any = ()


class EvalMetrics(NamedTuple):
    """Per-episode evaluation results; every leaf has a leading episode axis."""

    episode_return: Any
    agent_returns: Dict[str, Any]
    episode_length: Any


class TrainState(NamedTuple):
    """Parameters + optimizer state + bookkeeping for a trainer."""

    params: Any
    target_params: Any
    opt_state: Any
    steps: Any


class SystemState(NamedTuple):
    """Everything a running system owns; ``key`` is its `torch.Generator`."""

    train: TrainState
    buffer: Any
    env_state: Any
    timestep: Any
    carry: Any
    key: Any
