"""Greedy-policy evaluation (port of `repro.eval.evaluator`).

Episodes are fixed-length loops of ``env.horizon`` steps across
``num_envs`` batched env copies, with rewards masked after an env's first
LAST step (no auto-reset: each env copy plays exactly one episode).
Actions are greedy (``training=False``), and recurrent carries start at
zero and are threaded across the episode.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.core.types import EvalMetrics, TrainState
from repro_torch.envs.api import StepType


def _as_train_state(params_or_train) -> TrainState:
    """Accept a full TrainState or bare params."""
    if isinstance(params_or_train, TrainState):
        return params_or_train
    return TrainState(params_or_train, params_or_train, None, None)


def _episode_batch(system, train: TrainState, generator, num_envs: int, horizon: int):
    """Roll one batch of ``num_envs`` complete greedy episodes."""
    env = system.env
    ids = list(system.spec.agent_ids)
    device = generator.device
    env_state, ts = env.reset(num_envs, device, generator)
    carry = system.initial_carry((num_envs,), device)
    done = torch.zeros(num_envs, dtype=torch.bool, device=device)
    rets = {a: torch.zeros(num_envs, device=device) for a in ids}
    length = torch.zeros(num_envs, dtype=torch.int32, device=device)
    for _ in range(horizon):
        gs = env.global_state(env_state)
        actions, carry, _ = system.select_actions(
            train, ts.observation, gs, carry, generator, training=False
        )
        env_state, ts = env.step(env_state, actions)
        alive = ~done
        rets = {a: rets[a] + torch.where(alive, ts.reward[a], 0.0) for a in ids}
        length = length + alive.to(torch.int32)
        done = done | (ts.step_type == StepType.LAST)
    team = torch.mean(torch.stack([rets[a] for a in ids]), dim=0)
    return team, rets, length


def evaluate(
    system, params, seed: int = 0, num_episodes: int = 32, num_envs: int = 16, device=None
) -> EvalMetrics:
    """Greedy evaluation of ``params`` (a TrainState or bare params).

    Episodes run in rounds of ``min(num_envs, num_episodes)`` env copies;
    every `EvalMetrics` leaf has ``num_episodes`` rows.
    """
    if num_episodes < 1 or num_envs < 1:
        raise ValueError(
            f"num_episodes ({num_episodes}) and num_envs ({num_envs}) must be >= 1"
        )
    device = resolve_device(device)
    num_envs = min(num_envs, num_episodes)
    num_rounds = math.ceil(num_episodes / num_envs)
    ids = list(system.spec.agent_ids)
    horizon = int(system.env.horizon)
    train = _as_train_state(params)
    generator = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        rounds = [
            _episode_batch(system, train, generator, num_envs, horizon)
            for _ in range(num_rounds)
        ]
    flat = lambda xs: torch.cat(xs)[:num_episodes]
    return EvalMetrics(
        episode_return=flat([r[0] for r in rounds]),
        agent_returns={a: flat([r[1][a] for r in rounds]) for a in ids},
        episode_length=flat([r[2] for r in rounds]),
    )
