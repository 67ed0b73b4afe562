"""The `System` abstraction and the Anakin runner (port of `repro.core.system`).

A System bundles the executor (``select_actions`` + carry), the trainer
(``update``) and the dataset (buffer) as plain functions on tensors, as in
the reference.  `train_anakin` runs every env copy in one batch: act, env
step and rollout write for all copies per iteration, and the trainer
update whenever the dataset is ready.  The reference fuses this into one
``lax.scan`` under ``jit``; here it is a Python loop of batched tensor
ops, and the ``lax.cond`` update gate is a Python ``if`` on a Python int.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.core.types import SystemState, TrainState, Transition
from repro_torch.envs.api import StepType
from repro_torch.envs.wrappers import AutoReset, EpisodeStats, replace_reset_keys
from repro_torch.nn.recurrent import reset_carry


@dataclasses.dataclass(frozen=True)
class System:
    """A full MARL algorithm specification (executor + trainer + dataset).

    Signatures (``generator`` is a `torch.Generator` on the run's device):

    * ``init_train(generator) -> TrainState``
    * ``update(train, buffer, generator) -> (train, buffer, metrics)``
    * ``select_actions(train, obs, state, carry, generator, training)
      -> (actions, carry, extras)``
    * ``initial_carry(batch_shape, device) -> carry``
    * ``init_buffer(num_envs, device)``, ``observe(buffer, transition)``,
      ``can_sample(buffer) -> bool``
    """

    env: Any
    spec: Any
    init_train: Callable[[Any], TrainState]
    update: Callable
    select_actions: Callable
    initial_carry: Callable
    init_buffer: Callable
    observe: Callable
    can_sample: Callable
    name: str = "system"


def _training_env(env):
    """The runner-side wrapper stack: episode stats over fused auto-reset."""
    return EpisodeStats(AutoReset(env))


def _team_return(last_returns):
    """Mean-over-agents of the per-agent completed-episode returns."""
    return torch.mean(torch.stack(list(last_returns.values())), dim=0)


def _act_phase(system: System, tenv, train, env_state, timestep, carry, generator):
    """One vectorised acting step under ``train``'s policy (no dataset write).

    Returns ``(env_state, timestep, carry, transition, metrics)``.
    """
    num_envs = timestep.step_type.shape[0]
    device = timestep.step_type.device
    env_state = replace_reset_keys(env_state, generator)
    obs = timestep.observation
    gs = tenv.global_state(env_state)
    actions, new_carry, extras = system.select_actions(
        train, obs, gs, carry, generator, training=True
    )
    new_env_state, new_ts = tenv.step(env_state, actions)
    tr = Transition(
        obs=obs,
        actions=actions,
        rewards=new_ts.reward,
        discount=new_ts.discount,
        next_obs=new_ts.observation,
        state=gs,
        next_state=tenv.global_state(new_env_state),
        extras=extras,
        step_type=timestep.step_type,
    )
    # a FIRST out of step marks an auto-reset boundary: executor carries
    # restart with the new episode
    done = new_ts.step_type == StepType.FIRST
    new_carry = reset_carry(
        new_carry, done, initial=system.initial_carry((num_envs,), device)
    )
    done_f = done.float()
    metrics = {
        "reward": torch.mean(torch.stack(list(new_ts.reward.values()))),
        "done_frac": torch.mean(done_f),
        # mean return of the episodes that completed this iteration (0 if none)
        "episode_return": torch.sum(_team_return(new_env_state.last_returns) * done_f)
        / torch.clamp(torch.sum(done_f), min=1.0),
    }
    return new_env_state, new_ts, new_carry, tr, metrics


def _step_phase(system: System, tenv, st: SystemState):
    """One iteration except the trainer update: act, then write the dataset."""
    env_state, ts, carry, tr, metrics = _act_phase(
        system, tenv, st.train, st.env_state, st.timestep, st.carry, st.key
    )
    buffer = system.observe(st.buffer, tr)
    return SystemState(st.train, buffer, env_state, ts, carry, st.key), metrics


def _one_iteration(system: System, tenv, st: SystemState):
    """One vectorised step of every env, then the update if the dataset is ready.

    Returns ``(state, metrics, update_metrics or None)``.
    """
    with torch.no_grad():
        st, metrics = _step_phase(system, tenv, st)
    if not system.can_sample(st.buffer):
        return st, metrics, None
    train, buffer, upd = system.update(st.train, st.buffer, st.key)
    return st._replace(train=train, buffer=buffer), metrics, upd


def init_system_state(system: System, generator, num_envs: int, train_env=None):
    """A fresh `SystemState` on ``generator``'s device."""
    tenv = train_env if train_env is not None else _training_env(system.env)
    device = generator.device
    env_state, ts = tenv.reset(num_envs, device, generator)
    return SystemState(
        train=system.init_train(generator),
        buffer=system.init_buffer(num_envs, device),
        env_state=env_state,
        timestep=ts,
        carry=system.initial_carry((num_envs,), device),
        key=generator,
    )


def make_anakin(system: System, num_iterations: int, num_envs: int, device=None):
    """Build the Anakin program as a reusable function of ``seed``.

    ``program(seed) -> (SystemState, metrics)``; ``metrics`` maps
    ``reward`` / ``done_frac`` / ``episode_return`` to ``(num_iterations,)``
    tensors, and ``loss`` to the ``(num_updates,)`` mean losses of the
    updates that ran.  Nothing waits on the device inside the loop.
    """
    if num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {num_iterations}")
    device = resolve_device(device)
    tenv = _training_env(system.env)

    def program(seed: int):
        generator = torch.Generator(device).manual_seed(seed)
        st = init_system_state(system, generator, num_envs, train_env=tenv)
        per_iter, losses = [], []
        for _ in range(num_iterations):
            st, metrics, upd = _one_iteration(system, tenv, st)
            per_iter.append(metrics)
            if upd is not None:
                losses.append(upd["loss"])
        out = {k: torch.stack([m[k] for m in per_iter]) for k in per_iter[0]}
        out["loss"] = torch.stack(losses) if losses else torch.zeros(0, device=device)
        return st, out

    return program


def train_anakin(system: System, seed: int, num_iterations: int, num_envs: int, device=None):
    """Train for ``num_iterations`` vectorised steps of ``num_envs`` env copies.

    Returns ``(final SystemState, metrics)`` (see `make_anakin`).  ``device``
    defaults to CUDA and raises when none is present.
    """
    return make_anakin(system, num_iterations, num_envs, device)(seed)
