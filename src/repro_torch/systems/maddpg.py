"""MADDPG (Lowe et al. 2017) and MAD4PG (C51 critic, D4PG-style): port of `repro.systems.maddpg`.

Continuous-control actor-critic with centralised critics: each agent's
critic sees the global state and every agent's action (the
`CentralisedQValueCritic` architecture); execution is decentralised.
MAD4PG replaces the scalar critic with a C51 categorical critic and a
projected distributional Bellman target (Barth-Maron et al. 2018).  The
``architecture`` argument switches between decentralised, centralised
and networked critics: the paper's Block-4 code change.

As in `repro_torch.systems.offpolicy`, ``TrainState.steps`` is a Python
int and every function also runs seed lanes: one replay table, one
noise draw and one sample draw a lane, losses reduced within a lane.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import lanes, optim
from repro_torch.core.architectures import CentralisedQValueCritic
from repro_torch.core.buffer import buffer_add, buffer_can_sample, buffer_sample
from repro_torch.core.system import System
from repro_torch.core.types import TrainState, Transition
from repro_torch.envs.api import EnvSpec
from repro_torch.nn import MLP
from repro_torch.systems.offpolicy import init_replay_buffer
from repro_torch.systems.onpolicy import _apply, _sync, _value_and_grad
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class MaddpgConfig:
    """MADDPG/MAD4PG hyperparameters (same fields and defaults as the reference).

    ``distributed_axis`` averages the critic's and the actor's gradients
    over the ranks bound to that axis, both in one buffer.
    """

    hidden_sizes: Sequence[int] = (64, 64)
    actor_lr: float = 1e-3
    critic_lr: float = 3e-3
    gamma: float = 0.95
    tau: float = 0.01  # polyak
    buffer_capacity: int = 200_000
    batch_size: int = 512
    min_replay: int = 2_000
    sigma: float = 0.15  # exploration noise
    max_grad_norm: float = 10.0
    distributed_axis: Optional[str] = None
    # distributional (MAD4PG) head
    distributional: bool = False
    num_atoms: int = 51
    v_min: float = -150.0
    v_max: float = 20.0


def _action_noise(generator, batch_shape, act_dims, device):
    """Standard normal exploration noise, ``(*batch_shape, act_dims[i])`` for each agent.

    One draw a lane generator covers every agent.
    """
    z = lanes.randn(generator, (*batch_shape, sum(act_dims)), device)
    return list(torch.split(z, list(act_dims), dim=-1))


def project_distribution(target_probs, target_atoms, v_min: float, v_max: float):
    """C51 projection of probs at shifted atoms onto the fixed support ``linspace(v_min, v_max, A)``.

    ``target_probs`` and ``target_atoms`` are ``(..., A)``: every leading
    axis (the batch, and the seed lanes) is a batch axis of one
    ``scatter_add_`` on the last.  An atom that lands exactly on the
    support puts all its mass there (the ``lo == hi`` term).
    """
    num_atoms = target_probs.shape[-1]
    dz = (v_max - v_min) / (num_atoms - 1)
    b = (torch.clamp(target_atoms, v_min, v_max) - v_min) / dz
    lo, hi = torch.floor(b), torch.ceil(b)
    eq = (lo == hi).to(b.dtype)
    w_lo = target_probs * (hi - b + eq)
    w_hi = target_probs * (b - lo)
    out = torch.zeros_like(target_probs)
    out.scatter_add_(-1, lo.long(), w_lo)
    return out.scatter_add_(-1, hi.long(), w_hi)


def _polyak(target, online, tau: float):
    """``(1 - tau) * target + tau * online`` leafwise, as two multi-tensor ops."""
    pairs = []
    tree_map(lambda t, o: pairs.append((t, o)), target, online)
    new = torch._foreach_mul([t for t, _ in pairs], 1 - tau)
    torch._foreach_add_(new, [o for _, o in pairs], alpha=tau)
    it = iter(new)
    return tree_map(lambda _: next(it), target)


def make_maddpg(env, cfg: MaddpgConfig = MaddpgConfig(), architecture=None) -> System:
    """Build the centralised-critic DDPG `System` (continuous control)."""
    spec: EnvSpec = env.spec()
    ids = list(spec.agent_ids)
    arch = architecture or CentralisedQValueCritic(agent_order=tuple(ids))
    act_dims = {a: spec.actions[a].shape[0] for a in ids}
    obs_dims = {a: spec.observations[a].shape[0] for a in ids}
    state_dim = spec.state.shape[0]

    actors = {a: MLP((obs_dims[a], *cfg.hidden_sizes, act_dims[a])) for a in ids}

    def critic_in_dim(a):
        """The critic's input width, from a dummy input through the architecture."""
        obs = {b: torch.zeros(obs_dims[b]) for b in ids}
        acts = {b: torch.zeros(act_dims[b]) for b in ids}
        return arch.critic_input(obs, acts, torch.zeros(state_dim), a).shape[-1]

    out_dim = cfg.num_atoms if cfg.distributional else 1
    critics = {a: MLP((critic_in_dim(a), *cfg.hidden_sizes, out_dim)) for a in ids}
    support = {}  # the C51 atoms, made once a device

    def atoms(device):
        if device not in support:
            support[device] = torch.linspace(cfg.v_min, cfg.v_max, cfg.num_atoms, device=device)
        return support[device]

    actor_opt = optim.chain(
        optim.clip_by_global_norm(cfg.max_grad_norm), optim.adamw(cfg.actor_lr)
    )
    critic_opt = optim.chain(
        optim.clip_by_global_norm(cfg.max_grad_norm), optim.adamw(cfg.critic_lr)
    )

    def init_train(generator) -> TrainState:
        """The `TrainState` (params, targets, optimizers, update count 0) on ``generator``'s device."""
        params = {
            "actor": {a: actors[a].init(generator) for a in ids},
            "critic": {a: critics[a].init(generator) for a in ids},
        }
        opt_state = {
            "actor": actor_opt.init(params["actor"]),
            "critic": critic_opt.init(params["critic"]),
        }
        return TrainState(params, params, opt_state, 0)

    def policy(params, agent, obs):
        """The deterministic policy's action for one agent (tanh-squashed)."""
        return torch.tanh(actors[agent].apply(params["actor"][agent], obs))

    def critic_value(params, agent, obs, acts, gs):
        """The critic's value and raw output (scalar, or C51 logits) for one agent."""
        cin = arch.critic_input(obs, acts, gs, agent)
        out = critics[agent].apply(params["critic"][agent], cin)
        if cfg.distributional:
            probs = torch.softmax(out, dim=-1)
            return torch.sum(probs * atoms(out.device), dim=-1), out
        return out[..., 0], out

    def select_actions(train: TrainState, obs, state, carry, generator, training=True):
        """Deterministic actions, plus clipped Gaussian noise when ``training``."""
        del state  # decentralised execution
        mu = {a: policy(train.params, a, obs[a]) for a in ids}
        if not training:
            return mu, carry, {}
        first = mu[ids[0]]
        noise = _action_noise(generator, first.shape[:-1], [act_dims[a] for a in ids],
                              first.device)
        actions = {
            a: torch.clamp(mu[a] + noise[i] * cfg.sigma, -1.0, 1.0) for i, a in enumerate(ids)
        }
        return actions, carry, {}

    def initial_carry(batch_shape, device):
        """Feed-forward executors keep no memory."""
        del batch_shape, device
        return ()

    # ------------------------------------------------------------- trainer

    def critic_loss_fn(cparams, params, target_params, batch: Transition):
        """TD (or C51 cross-entropy) loss against the target actors and critics, per lane."""
        loss = 0.0
        p = dict(params, critic=cparams)
        with torch.no_grad():
            next_acts = {a: policy(target_params, a, batch.next_obs[a]) for a in ids}
        for a in ids:
            q, logits = critic_value(p, a, batch.obs, batch.actions, batch.state)
            r = batch.rewards[a]
            with torch.no_grad():
                qn, next_logits = critic_value(
                    target_params, a, batch.next_obs, next_acts, batch.next_state
                )
                if cfg.distributional:
                    target_atoms = (
                        r[..., None] + cfg.gamma * batch.discount[..., None] * atoms(r.device)
                    )
                    proj = project_distribution(
                        torch.softmax(next_logits, dim=-1), target_atoms, cfg.v_min, cfg.v_max
                    )
                else:
                    target = r + cfg.gamma * batch.discount * qn
            if cfg.distributional:
                logp = torch.log_softmax(logits, dim=-1)
                loss = loss + torch.mean(-torch.sum(proj * logp, dim=-1), dim=-1)
            else:
                loss = loss + torch.mean(torch.square(q - target), dim=-1)
        return loss

    def actor_loss_fn(aparams, params, batch: Transition):
        """Deterministic policy-gradient loss through the (fixed) critics, per lane."""
        loss = 0.0
        p = dict(params, actor=aparams)
        for a in ids:
            acts = dict(batch.actions)
            acts[a] = policy(p, a, batch.obs[a])
            q, _ = critic_value(p, a, batch.obs, acts, batch.state)
            loss = loss - torch.mean(q, dim=-1)
        return loss

    def update(train: TrainState, buffer, generator):
        """One trainer update: ``(train, buffer, generator) -> (train, buffer, metrics)``."""
        S = lanes.count(generator)
        batch = buffer_sample(buffer, generator, cfg.batch_size)
        closs, cgrads = _value_and_grad(
            critic_loss_fn, train.params["critic"], train.params, train.target_params, batch
        )
        aloss, agrads = _value_and_grad(actor_loss_fn, train.params["actor"], train.params, batch)
        cgrads, agrads = _sync(cfg, (cgrads, agrads))
        with torch.no_grad():
            critic, c_opt = _apply(critic_opt, cgrads, train.opt_state["critic"],
                                   train.params["critic"], S)
            actor, a_opt = _apply(actor_opt, agrads, train.opt_state["actor"],
                                  train.params["actor"], S)
            params = {"actor": actor, "critic": critic}
            target_params = _polyak(train.target_params, params, cfg.tau)
        return (
            TrainState(params, target_params, {"actor": a_opt, "critic": c_opt}, train.steps + 1),
            buffer,
            {"critic_loss": closs, "actor_loss": aloss},
        )

    # ------------------------------------------------------------- dataset

    def example_transition():
        """A zero `Transition` fixing the table's shapes and dtypes (float actions)."""
        obs = {a: torch.zeros(spec.observations[a].shape) for a in ids}
        return Transition(
            obs=obs,
            actions={a: torch.zeros(act_dims[a]) for a in ids},
            rewards={a: torch.zeros(()) for a in ids},
            discount=torch.zeros(()),
            next_obs=obs,
            state=torch.zeros(spec.state.shape),
            next_state=torch.zeros(spec.state.shape),
            extras={},
            step_type=torch.zeros((), dtype=torch.int32),
        )

    def init_buffer(batch_shape, device):
        """A fresh replay table (one a lane with ``batch_shape = (S, N)``)."""
        return init_replay_buffer(example_transition(), cfg.buffer_capacity, batch_shape, device)

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
        name="mad4pg" if cfg.distributional else "maddpg",
        action_space="continuous",
    )


def make_mad4pg(env, cfg: MaddpgConfig = MaddpgConfig(), architecture=None) -> System:
    """MADDPG with a C51 distributional critic (the MAD4PG variant)."""
    return make_maddpg(env, dataclasses.replace(cfg, distributional=True), architecture)
