"""DIAL and RIAL: recurrent Q-agents with a learned channel (port of `repro.systems.dial`).

Differentiable Inter-Agent Learning (Foerster et al. 2016), the paper's
switch-riddle probe, as a `System`.  Every agent shares one stack:
encoder -> memory core -> a Q-head and a message head, and the agents run
through it together, stacked along a leading agent axis (one launch an
op serves them all, where the reference loops over them).  The executor acts
eps-greedily and sends a message each step (the typed `Carry` holds the
hidden states and the outgoing messages); the messages and the incoming
carry ride in ``Transition.extras``.  Once a rollout of ``rollout_len``
steps (default: the env's horizon) is complete, the trainer re-runs the
agents over it from the stored window-start carry and minimises the TD
error of the chosen actions' Q's against the target network's.

Two protocols:

* ``dial``: the channel is the DRU (`repro_torch.core.modules.dru`),
  ``sigmoid(m + noise)`` in training, so TD gradients flow between agents
  through the messages, which the re-run recomputes; greedy execution
  (``training=False``) thresholds them to bits;
* ``rial``: each agent picks its message bits eps-greedily from the
  message head's Q's and learns them by TD; the re-run teacher-forces the
  stored bits.

Two BPTT routes.  With the channel on (or the GRU core), each step's
messages feed the next step's inputs, so the re-run is a Python loop over
time, resetting the carry at stored FIRST rows.  With ``use_comm=False``,
the linear core and ``dial`` (the fused route), the inputs are the stored
observations alone: one `LinearScannedRNN.unroll` for all the agents, one
launch of the recurrent-scan kernel, with FIRST rows folded in as resets.

Random draws go through hooks that tests replace with the reference's:
the eps-greedy action and bit draws through `_explore_draws` (the replay
family's), the DRU noise through `_dru_noise`.  The update count
``TrainState.steps`` is a Python int (eps and the target sync are decided
on the host), and every function runs seed lanes (`repro_torch.lanes`).
With ``distributed_axis`` each update's gradients are averaged over the
ranks bound to that axis.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import lanes, optim
from repro_torch.core.buffer import (
    rollout_add,
    rollout_init,
    rollout_ready,
    rollout_reset,
    rollout_take,
)
from repro_torch.core.modules.communication import BroadcastedCommunication, dru
from repro_torch.core.system import System
from repro_torch.core.types import Carry, TrainState, Transition
from repro_torch.envs.api import StepType
from repro_torch.nn import MLP
from repro_torch.nn.recurrent import make_core, reset_carry, window_start_carry
from repro_torch.systems.offpolicy import _explore_draws, linear_eps
from repro_torch.systems.onpolicy import (
    _apply,
    _example_transition,
    _sync,
    _take,
    _value_and_grad,
)


@dataclasses.dataclass(frozen=True)
class DialConfig:
    """DIAL/RIAL hyperparameters (the reference's fields and defaults).

    ``use_comm=False`` is the no-channel ablation (recurrent independent
    Q-learners); ``recurrent_core`` picks ``"gru"`` or ``"linear"``;
    ``protocol`` is ``"dial"`` or ``"rial"``; ``rollout_len`` None means
    the env's horizon.
    """

    hidden_dim: int = 64
    channel_size: int = 1
    noise_std: float = 0.5
    learning_rate: float = 5e-4
    gamma: float = 1.0
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_updates: int = 300
    target_update_period: int = 20
    max_grad_norm: float = 10.0
    use_comm: bool = True
    recurrent_core: str = "gru"
    protocol: str = "dial"
    rollout_len: Optional[int] = None
    distributed_axis: Optional[str] = None  # pmean grads over this axis's ranks


class DialNets(NamedTuple):
    """The shared per-agent network stack (encoder -> memory core -> heads)."""

    encoder: MLP
    core: object
    q_head: MLP
    msg_head: MLP


def _dru_noise(generator, batch_shape, num_agents: int, channel_size: int, device):
    """Each agent's standard-normal DRU noise ``(*batch_shape, channel_size)``, in agent order.

    One draw a lane generator covers every agent.
    """
    z = lanes.randn(generator, (*batch_shape[:-1], num_agents, batch_shape[-1], channel_size),
                    device)
    return [z[..., i, :, :] for i in range(num_agents)]


def dial_eps_at(cfg: DialConfig, steps: int) -> float:
    """The exploration epsilon after ``steps`` updates (decayed over ``eps_decay_updates``)."""
    return linear_eps(cfg.eps_start, cfg.eps_end, cfg.eps_decay_updates, steps)


def make_dial(env, cfg: DialConfig = DialConfig()) -> System:
    """Build the DIAL (or RIAL, by ``cfg.protocol``) communicating `System`."""
    spec = env.spec()
    ids = list(spec.agent_ids)
    n = len(ids)
    obs_dim = spec.observations[ids[0]].shape[0]
    num_actions = spec.actions[ids[0]].num_values
    C = cfg.channel_size
    comm = BroadcastedCommunication(C, cfg.noise_std, shared=True)
    in_dim = obs_dim + (comm.incoming_size(n) if cfg.use_comm else 0)
    rollout_len = cfg.rollout_len or int(env.horizon)
    rial = cfg.protocol == "rial"
    nets = DialNets(
        encoder=MLP((in_dim, cfg.hidden_dim), activate_final=True),
        core=make_core(cfg.recurrent_core, cfg.hidden_dim, cfg.hidden_dim),
        q_head=MLP((cfg.hidden_dim, cfg.hidden_dim, num_actions)),
        msg_head=MLP((cfg.hidden_dim, cfg.hidden_dim, 2 * C if rial else C)),
    )
    # with the channel off and the linear core, a window's inputs are all
    # known up front: the re-run is one fused unroll an agent
    fused_bptt = not cfg.use_comm and not rial and cfg.recurrent_core != "gru"
    opt = optim.chain(optim.clip_by_global_norm(cfg.max_grad_norm),
                      optim.adamw(cfg.learning_rate))

    def init_train(generator) -> TrainState:
        """The `TrainState` (params, targets, optimizer, update count 0) on ``generator``'s device."""
        params = {k: getattr(nets, k).init(generator)
                  for k in ("encoder", "core", "q_head", "msg_head")}
        return TrainState(params, params, opt.init(params), 0)

    def agent_step(params, obs_a, msg_in, h):
        """One memory-core step of one agent: ``-> (q, message logits, h)``."""
        x = torch.cat([obs_a, msg_in], dim=-1) if cfg.use_comm else obs_a
        h, y = nets.core.step(params["core"], h, nets.encoder.apply(params["encoder"], x))
        return (nets.q_head.apply(params["q_head"], y), nets.msg_head.apply(params["msg_head"], y),
                h)

    def initial_carry(batch_shape, device):
        """The executor's zero memory and messages for a ``batch_shape`` of envs."""
        zeros = lambda d: {a: torch.zeros(*batch_shape, d, device=device) for a in ids}
        return Carry(hidden=zeros(cfg.hidden_dim), message=zeros(C))

    def stacked(per_agent, dim=0):
        """A per-agent dict -> one tensor, the agents stacked along ``dim`` (in ``ids`` order)."""
        return torch.stack([per_agent[a] for a in ids], dim)

    def unstacked(x):
        """The inverse of `stacked` along axis 0: one view an agent."""
        return dict(zip(ids, x.unbind(0)))

    def messages(m, generator, training):
        """The DRU over the agents' message logits ``(n, ..., C)`` (noise only in training)."""
        noise = None
        if training:
            noise = torch.stack(_dru_noise(generator, m.shape[1:-1], n, C, m.device))
        return dru(m, noise, cfg.noise_std, training)

    def explore(generator, greedy, num_values, eps):
        """Eps-greedy over stacked greedy choices ``(n, ...)``, one draw set an agent."""
        rand, u = _explore_draws(generator, greedy.shape[1:], [num_values] * n, greedy.device)
        return torch.where(torch.stack(u) < eps, torch.stack(rand), greedy)

    # ------------------------------------------------------------ executor

    def select_actions(train: TrainState, obs, state, carry, generator, training=True):
        """Eps-greedy act step; messages ride the `Carry` and the extras.

        Every agent runs through the shared stack in one batch, stacked
        along a leading agent axis.
        """
        del state  # decentralised execution
        msg_in = comm.route_stacked(stacked(carry.message)) if cfg.use_comm else None
        q, m, h = agent_step(train.params, stacked(obs), msg_in, stacked(carry.hidden))
        actions = torch.argmax(q, dim=-1).to(torch.int32)  # (n, ...)
        eps = dial_eps_at(cfg, train.steps) if training else 0.0
        if training:  # at eps 0 the reference's draws never explore
            actions = explore(generator, actions, num_actions, eps)
        extras = {}
        if rial:
            # the message bits: eps-greedy actions of the message head's Q's
            bits = torch.argmax(m.unflatten(-1, (C, 2)), dim=-1).to(torch.int32)
            if training:
                bits = explore(generator, bits, 2, eps)
            extras["msg_bits"] = unstacked(bits)
            out = bits.float()
        else:
            out = messages(m, generator, training)
        out = unstacked(out)
        extras.update(msgs=out, carry_in=carry)
        return unstacked(actions), Carry(hidden=unstacked(h), message=out), extras

    # ------------------------------------------------------------- trainer

    def q_trajectory(params, traj: Transition, generator, bootstrap: bool):
        """The re-run over a stored ``(T, [S,] B)`` trajectory, from the stored start carry.

        Every agent runs through the shared stack together: the results lead
        with ``(T, n)``.  Returns ``(qs, q_boot, msg_qs, msg_q_boot)``: the
        Q's of every row and, with ``bootstrap``, of one more step on the
        last next-observation (else None; only the target's is used).  RIAL
        adds the message Q's, ``(..., C, 2)``; DIAL returns None for them.
        """
        carry0 = window_start_carry(traj.extras, initial_carry, traj.discount.shape[1:],
                                    traj.discount.device)
        h = stacked(carry0.hidden)  # (n, [S,] B, H)
        obs = stacked(traj.obs, 1)  # (T, n, [S,] B, obs)
        first = (traj.step_type == StepType.FIRST).unsqueeze(1).expand(obs.shape[:-1])
        last_obs = stacked({a: traj.next_obs[a][-1] for a in ids})
        if fused_bptt:  # one unroll for every agent: one kernel launch
            z = nets.encoder.apply(params["encoder"], obs)
            h_fin, hs = nets.core.unroll(params["core"], h, z, first)
            qs = nets.q_head.apply(params["q_head"], hs)
            # the bootstrap step on the final next-obs (no reset row)
            q_boot = agent_step(params, last_obs, None, h_fin)[0] if bootstrap else None
            return qs, q_boot, None, None

        msgs = stacked(traj.extras["msgs"], 1)  # (T, n, [S,] B, C)

        def cell(h, message, obs_t, msgs_t):
            """One re-run step: the Q's (and message Q's), the carry after it."""
            msg_in = comm.route_stacked(message) if cfg.use_comm else None
            q, m, h = agent_step(params, obs_t, msg_in, h)
            if rial:  # teacher-forced bits
                return h, msgs_t, q, m.unflatten(-1, (C, 2))
            return h, messages(m, generator, True), q, None

        message, rows = stacked(carry0.message), []
        for t in range(obs.shape[0]):
            # memory (hidden and stale messages) restarts where a row opens an episode
            h, message = reset_carry((h, message), first[t])
            h, message, q, msg_q = cell(h, message, obs[t], msgs[t])
            rows.append((q, msg_q))
        qs = torch.stack([r[0] for r in rows])
        msg_qs = torch.stack([r[1] for r in rows]) if rial else None
        if not bootstrap:
            return qs, None, msg_qs, None
        _, _, q_boot, msg_q_boot = cell(h, message, last_obs, msgs[-1])
        return qs, q_boot, msg_qs, msg_q_boot

    def loss_fn(params, target_params, traj: Transition, generator):
        """Mean squared TD error of the re-run Q's (and RIAL's message Q's), per lane."""
        qs, _, msg_qs, _ = q_trajectory(params, traj, generator, bootstrap=False)
        with torch.no_grad():
            qs_t, q_boot_t, msg_qs_t, msg_q_boot_t = q_trajectory(target_params, traj, generator,
                                                                  bootstrap=True)
        lanes_ = lanes.count(generator)
        # rows (T, n, [S,] B, ...): a sum within a lane
        reduce = lambda x: torch.sum(torch.square(x), dim=[d for d in range(x.dim()) if d != 2]
                                     if lanes_ else None)
        d = traj.discount.unsqueeze(1)  # (T, 1, [S,] B), 0 at terminal rows
        r = stacked(traj.rewards, 1)
        q_next = torch.cat([qs_t[1:], q_boot_t[None]])
        td = _take(qs, stacked(traj.actions, 1)) - (r + cfg.gamma * d * torch.amax(q_next, -1))
        total, count = reduce(td), td.numel()
        if rial:  # the message bits' Q-learning
            qmb = _take(msg_qs, stacked(traj.extras["msg_bits"], 1))  # (T, n, [S,] B, C)
            qm_next = torch.cat([msg_qs_t[1:], msg_q_boot_t[None]])
            td_m = qmb - (r[..., None] + cfg.gamma * d[..., None] * torch.amax(qm_next, -1))
            total, count = total + reduce(td_m), count + td_m.numel()
        return total / (count // (lanes_ or 1))

    def update(train: TrainState, buffer, generator):
        """One BPTT update over the consumed rollout, then the periodic target sync."""
        traj = rollout_take(buffer)
        loss, grads = _value_and_grad(loss_fn, train.params, train.target_params, traj,
                                      generator)
        grads = _sync(cfg, grads)
        with torch.no_grad():
            params, opt_state = _apply(opt, grads, train.opt_state, train.params,
                                       lanes.count(generator))
        steps = train.steps + 1
        # the hard sync, decided on the host (params are never written in place)
        target_params = params if steps % cfg.target_update_period == 0 else train.target_params
        return (TrainState(params, target_params, opt_state, steps), rollout_reset(buffer),
                {"loss": loss, "eps": dial_eps_at(cfg, steps)})

    # ------------------------------------------------------------- dataset

    def init_buffer(batch_shape, device):
        """A fresh rollout for ``batch_shape`` envs (``N``, or ``(S, N)``)."""
        extras = {"msgs": {a: torch.zeros(C) for a in ids},
                  "carry_in": initial_carry((), "cpu")}
        if rial:
            extras["msg_bits"] = {a: torch.zeros(C, dtype=torch.int32) for a in ids}
        return rollout_init(_example_transition(spec, extras), rollout_len, batch_shape, device)

    return System(
        env=env,
        spec=spec,
        init_train=init_train,
        update=update,
        select_actions=select_actions,
        initial_carry=initial_carry,
        init_buffer=init_buffer,
        observe=rollout_add,
        can_sample=lambda buf: rollout_ready(buf, rollout_len),
        name=cfg.protocol if cfg.use_comm else "rec-madqn",
    )
