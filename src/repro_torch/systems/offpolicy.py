"""Generic off-policy value-based MARL builder: MADQN / VDN / QMIX (port of `repro.systems.offpolicy`).

One builder covers the value-decomposition family: the ``mixer`` argument
selects independent learners (None: MADQN), additive mixing (VDN) or
monotonic hypernetwork mixing (QMIX).  Double-DQN targets, a hard target
sync every ``target_update_period`` updates, eps-greedy acting with a
linear schedule, optional weight sharing across agents and optional
fingerprint replay stabilisation, as in the reference.

The update count ``TrainState.steps`` is a Python int here (the
reference's is an int32 array): eps, the fingerprint and the target sync
depend on it alone, and every seed lane updates in step, so they are
decided on the host and never wait on the device (the fingerprint's two
numbers reach it as fill values, not as a copy).  Every function also
runs seed lanes (`repro_torch.lanes`): params and optimizer state lead
with the lane axis, the replay table holds one table a lane, each lane
draws its exploration and its samples from its own generator, and the
losses reduce within a lane.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import lanes, optim
from repro_torch.core.buffer import buffer_add, buffer_can_sample, buffer_init, buffer_sample
from repro_torch.core.modules.stabilisation import FingerPrintStabilisation
from repro_torch.core.system import System
from repro_torch.core.types import TrainState, Transition
from repro_torch.envs.api import EnvSpec
from repro_torch.nn import MLP
from repro_torch.systems.onpolicy import (
    _apply,
    _example_transition,
    _sync,
    _take,
    _value_and_grad,
)


@dataclasses.dataclass(frozen=True)
class OffPolicyConfig:
    """Replay-family hyperparameters (same fields and defaults as the reference).

    ``distributed_axis`` averages each update's gradients over the ranks
    bound to that axis (`repro_torch.distributed.collective.pmean`).
    """

    hidden_sizes: Sequence[int] = (64, 64)
    learning_rate: float = 5e-4
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    batch_size: int = 64
    min_replay: int = 500
    target_update_period: int = 100
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 10_000
    shared_weights: bool = True
    max_grad_norm: float = 10.0
    fingerprint: bool = False
    distributed_axis: Optional[str] = None  # pmean grads over this axis's ranks
    updates_per_step: int = 1


def linear_eps(start: float, end: float, decay: int, steps: int) -> float:
    """Epsilon decayed linearly from ``start`` to ``end`` over ``decay`` updates, after ``steps``.

    Computed in float32 on the host, as the reference computes it on the
    device.
    """
    frac = np.clip(np.float32(steps) / np.float32(decay), 0.0, 1.0)
    return float(np.float32(start) + frac * np.float32(end - start))


def eps_at(cfg: OffPolicyConfig, steps: int) -> float:
    """The exploration epsilon after ``steps`` updates (`linear_eps` of the config)."""
    return linear_eps(cfg.eps_start, cfg.eps_end, cfg.eps_decay_steps, steps)


def _explore_draws(generator, batch_shape, num_actions, device):
    """Each agent's uniform random action and its ``[0, 1)`` explore draw, of ``batch_shape``.

    One draw a lane generator covers every agent; the random action is
    ``floor(u * num_actions)`` of its own uniform.  Returns two lists in
    agent order.
    """
    n = len(num_actions)
    u = lanes.rand(generator, (*batch_shape[:-1], n, 2, batch_shape[-1]), device)
    rand = [
        (u[..., i, 0, :] * A).to(torch.int32).clamp_(max=A - 1)
        for i, A in enumerate(num_actions)
    ]
    return rand, [u[..., i, 1, :] for i in range(n)]


def init_replay_buffer(example, capacity: int, batch_shape, device):
    """A replay table for ``batch_shape`` envs: ``N`` (or 1), or ``(S, N)`` with one table a lane.

    Rows are flattened across envs, so only the lane count matters.
    """
    lane_count = None if isinstance(batch_shape, int) or len(batch_shape) == 1 else batch_shape[0]
    return buffer_init(example, capacity, device, lane_count)


def make_offpolicy_system(env, cfg: OffPolicyConfig, mixer=None, name="madqn") -> System:
    """Build a replay-based Q-learning `System` (the MADQN/VDN/QMIX core)."""
    spec: EnvSpec = env.spec()
    ids = list(spec.agent_ids)
    num_actions = {a: spec.actions[a].num_values for a in ids}
    fp = FingerPrintStabilisation() if cfg.fingerprint else None
    obs_dims = {a: spec.observations[a].shape[0] + (fp.size if fp else 0) for a in ids}
    state_dim = spec.state.shape[0]

    # one Q-net per agent, or one shared net when homogeneous
    homogeneous = len({(obs_dims[a], num_actions[a]) for a in ids}) == 1
    share = cfg.shared_weights and homogeneous
    nets = {a: MLP((obs_dims[a], *cfg.hidden_sizes, num_actions[a])) for a in ids}

    opt = optim.chain(
        optim.clip_by_global_norm(cfg.max_grad_norm),
        optim.adamw(cfg.learning_rate),
    )

    def init_params(generator):
        """Per-agent Q-net parameters (one shared net when homogeneous)."""
        if share:
            return {"shared": nets[ids[0]].init(generator)}
        return {a: nets[a].init(generator) for a in ids}

    def q_values(params, agent, obs):
        """Per-agent Q-values for an observation batch."""
        p = params["shared"] if share else params[agent]
        return nets[agent].apply(p, obs)

    def init_train(generator) -> TrainState:
        """The `TrainState` (params, targets, optimizer, update count 0) on ``generator``'s device."""
        params = {"q": init_params(generator)}
        if mixer is not None:
            params["mixer"] = mixer.init(generator, len(ids), state_dim)
        return TrainState(params=params, target_params=params, opt_state=opt.init(params),
                          steps=0)

    def _augment(obs, steps):
        if fp is None:
            return obs
        return fp.augment(obs, eps_at(cfg, steps), steps)

    def select_actions(train: TrainState, obs, state, carry, generator, training=True):
        """Eps-greedy actions from the per-agent Q-nets (greedy when not ``training``)."""
        del state  # decentralised execution
        obs = _augment(obs, train.steps)
        greedy = {
            a: torch.argmax(q_values(train.params["q"], a, obs[a]), dim=-1).to(torch.int32)
            for a in ids
        }
        if not training:  # eps 0: the reference's draws never explore
            return greedy, carry, {}
        eps = eps_at(cfg, train.steps)
        batch_shape = greedy[ids[0]].shape
        rand, explore = _explore_draws(
            generator, batch_shape, [num_actions[a] for a in ids], greedy[ids[0]].device
        )
        actions = {a: torch.where(explore[i] < eps, rand[i], greedy[a]) for i, a in enumerate(ids)}
        return actions, carry, {}

    def initial_carry(batch_shape, device):
        """Feed-forward executors keep no memory."""
        del batch_shape, device
        return ()

    # ------------------------------------------------------------- trainer

    def loss_fn(params, target_params, batch: Transition, steps):
        """Double-DQN TD loss (mixed over agents when a mixer is set), per lane."""
        obs, next_obs = batch.obs, batch.next_obs
        if fp is not None:  # the current update count, for stored and next obs alike
            eps = eps_at(cfg, steps)
            obs = fp.augment(obs, eps, steps)
            next_obs = fp.augment(next_obs, eps, steps)
        chosen, targets = [], []
        for a in ids:
            chosen.append(_take(q_values(params["q"], a, obs[a]), batch.actions[a]))
            with torch.no_grad():  # double-DQN target: online argmax, target value
                best = torch.argmax(q_values(params["q"], a, next_obs[a]), dim=-1)
                targets.append(_take(q_values(target_params["q"], a, next_obs[a]), best))
        chosen = torch.stack(chosen, dim=-1)  # ([S,] B, N)
        targets = torch.stack(targets, dim=-1)
        r = torch.stack([batch.rewards[a] for a in ids], dim=-1)
        if mixer is None:
            td_target = r + cfg.gamma * batch.discount[..., None] * targets
            return torch.mean(torch.square(chosen - td_target), dim=(-2, -1))
        q_tot = mixer.apply(params["mixer"], chosen, batch.state)
        with torch.no_grad():
            q_tot_next = mixer.apply(target_params["mixer"], targets, batch.next_state)
            # cooperative: the team reward is the mean of the agents' rewards
            td_target = torch.mean(r, dim=-1) + cfg.gamma * batch.discount * q_tot_next
        return torch.mean(torch.square(q_tot - td_target), dim=-1)

    def update(train: TrainState, buffer, generator):
        """One trainer update: ``(train, buffer, generator) -> (train, buffer, metrics)``."""
        batch = buffer_sample(buffer, generator, cfg.batch_size)
        loss, grads = _value_and_grad(
            loss_fn, train.params, train.target_params, batch, train.steps
        )
        grads = _sync(cfg, grads)
        with torch.no_grad():
            params, opt_state = _apply(opt, grads, train.opt_state, train.params,
                                       lanes.count(generator))
        steps = train.steps + 1
        # the hard sync, decided on the host: params are never written in
        # place, so the targets can share their tensors
        target_params = params if steps % cfg.target_update_period == 0 else train.target_params
        return (
            TrainState(params, target_params, opt_state, steps),
            buffer,
            {"loss": loss, "eps": eps_at(cfg, steps)},
        )

    # ------------------------------------------------------------- dataset

    def init_buffer(batch_shape, device):
        """A fresh replay table (one a lane with ``batch_shape = (S, N)``)."""
        return init_replay_buffer(_example_transition(spec, {}), cfg.buffer_capacity,
                                  batch_shape, device)

    return System(
        env=env,
        spec=spec,
        init_train=init_train,
        update=update,
        select_actions=select_actions,
        initial_carry=initial_carry,
        init_buffer=init_buffer,
        observe=buffer_add,
        can_sample=lambda buf: buffer_can_sample(buf, cfg.min_replay),
        updates_per_step=cfg.updates_per_step,
        name=name,
    )
