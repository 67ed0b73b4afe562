"""rec-MADQN: recurrent independent Q-learning over sequence replay (port of `repro.systems.rec_madqn`).

R2D2's recipe (Kapturowski et al. 2019) with one learner an agent:
encoder -> memory core -> Q-head stacks, trained from the sequence table
(`repro_torch.core.buffer.SeqBufferState`).  The executor stores its
incoming carry each step (``Transition.extras["carry_in"]``), so a
sampled window opens from the stored memory; the first ``burn_in`` rows
warm it under the current online and target weights with no gradient
(`burn_in_carry`), and double-DQN TD runs over the remaining ``seq_len``
rows: online argmax, target value, the next-step Q's shifted within the
window plus one bootstrap step on the last next-observation, gated by the
stored discount, with memory reset at stored FIRST rows.  A hard target
sync every ``target_update_period`` updates.

Weights are shared across agents when the env is homogeneous and
``shared_weights`` is set, and then every agent's rows go through the one
stack together, stacked along a leading agent axis; otherwise each agent
has its own stack (speaker_listener).  With ``recurrent_core="linear"``
every unroll of a stack (both burn-ins, the online and the target suffix,
and the backward of the online one) is one launch of the recurrent-scan
kernel: 5 an update for a shared stack.

As in the replay family (`repro_torch.systems.offpolicy`), the update
count ``TrainState.steps`` is a Python int, so eps and the target sync are
decided on the host; every function also runs seed lanes
(`repro_torch.lanes`), and the losses reduce within a lane.  With
``distributed_axis`` each update's gradients are averaged over the ranks
bound to that axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import lanes, optim
from repro_torch.core.buffer import seq_add, seq_can_sample, seq_init, seq_sample
from repro_torch.core.system import System
from repro_torch.core.types import Carry, TrainState, Transition
from repro_torch.envs.api import EnvSpec, StepType
from repro_torch.nn import MLP
from repro_torch.nn.recurrent import burn_in_carry, make_core, window_start_carry
from repro_torch.systems.offpolicy import _explore_draws, eps_at
from repro_torch.systems.onpolicy import (
    _apply,
    _example_transition,
    _sync,
    _take,
    _value_and_grad,
)


@dataclasses.dataclass(frozen=True)
class RecMadqnConfig:
    """R2D2-style recurrent Q-learning hyperparameters (the reference's fields and defaults).

    A replay window is ``burn_in + seq_len`` steps; ``stride`` spaces
    window starts (None: ``seq_len``, so consecutive windows overlap by the
    burn-in).  ``buffer_capacity``, ``min_windows`` and ``batch_size``
    count windows.
    """

    hidden_sizes: Sequence[int] = (64,)
    learning_rate: float = 5e-4
    gamma: float = 0.99
    seq_len: int = 8
    burn_in: int = 4
    stride: Optional[int] = None
    buffer_capacity: int = 2048
    batch_size: int = 32
    min_windows: int = 64
    target_update_period: int = 100
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 10_000
    shared_weights: bool = True
    recurrent_core: str = "gru"
    max_grad_norm: float = 10.0
    distributed_axis: Optional[str] = None
    updates_per_step: int = 1


def make_rec_madqn(env, cfg: RecMadqnConfig = RecMadqnConfig()) -> System:
    """Build the recurrent MADQN `System` over sequence replay."""
    spec: EnvSpec = env.spec()
    ids = list(spec.agent_ids)
    num_actions = {a: spec.actions[a].num_values for a in ids}
    obs_dims = {a: spec.observations[a].shape[0] for a in ids}
    hidden = cfg.hidden_sizes[-1]
    window_len = cfg.burn_in + cfg.seq_len
    stride = cfg.seq_len if cfg.stride is None else cfg.stride
    if cfg.seq_len < 1 or cfg.burn_in < 0 or stride < 1:
        raise ValueError(
            f"need seq_len >= 1, burn_in >= 0, stride >= 1; got "
            f"seq_len={cfg.seq_len}, burn_in={cfg.burn_in}, stride={stride}"
        )
    share = cfg.shared_weights and len({(obs_dims[a], num_actions[a]) for a in ids}) == 1

    def stack(in_dim, out_dim):
        """One encoder -> memory core -> Q-head stack."""
        return {
            "encoder": MLP((in_dim, *cfg.hidden_sizes), activate_final=True),
            "core": make_core(cfg.recurrent_core, hidden, hidden),
            "head": MLP((hidden, out_dim)),
        }

    nets = {a: stack(obs_dims[a], num_actions[a]) for a in ids}
    opt = optim.chain(optim.clip_by_global_norm(cfg.max_grad_norm),
                      optim.adamw(cfg.learning_rate))

    def init_stack(net, generator):
        return {k: net[k].init(generator) for k in ("encoder", "core", "head")}

    def init_params(generator):
        """Per-agent Q-stacks (one shared stack when homogeneous)."""
        if share:
            return {"shared": init_stack(nets[ids[0]], generator)}
        return {a: init_stack(nets[a], generator) for a in ids}

    # the agents that run through one stack together: all of them when the
    # weights are shared (one launch serves every agent), else one each
    groups = [ids] if share else [[a] for a in ids]

    def _p(params, group):
        return params["shared"] if share else params[group[0]]

    def _agents(xs, dim):
        """Per-agent tensors stacked along a new ``dim`` (a view for a single agent)."""
        return xs[0].unsqueeze(dim) if len(xs) == 1 else torch.stack(xs, dim)

    def q_step(params, group, h, x):
        """One act-time step of a group's stack: ``(h, obs) -> (h, q_values)``, agents leading."""
        net, p = nets[group[0]], _p(params, group)
        h, y = net["core"].step(p["core"], h, net["encoder"].apply(p["encoder"], x))
        return h, net["head"].apply(p["head"], y)

    def q_unroll(params, group, h, xs, resets):
        """BPTT over ``(T, agents, [S,] B, obs)`` rows with FIRST-row resets."""
        net, p = nets[group[0]], _p(params, group)
        h, ys = net["core"].unroll(p["core"], h, net["encoder"].apply(p["encoder"], xs), resets)
        return h, net["head"].apply(p["head"], ys)

    def init_train(generator) -> TrainState:
        """The `TrainState` (params, targets, optimizer, update count 0) on ``generator``'s device."""
        params = init_params(generator)
        return TrainState(params, params, opt.init(params), 0)

    # ------------------------------------------------------------ executor

    def initial_carry(batch_shape, device):
        """The executor's zero memory for a ``batch_shape`` of envs."""
        return Carry(hidden={a: torch.zeros(*batch_shape, hidden, device=device) for a in ids})

    def select_actions(train: TrainState, obs, state, carry, generator, training=True):
        """Eps-greedy recurrent act step; in training the incoming carry rides in extras."""
        del state  # decentralised execution
        new_h, greedy = {}, {}
        for group in groups:
            h, q = q_step(train.params, group, _agents([carry.hidden[a] for a in group], 0),
                          _agents([obs[a] for a in group], 0))
            best = torch.argmax(q, dim=-1).to(torch.int32)
            for i, a in enumerate(group):
                new_h[a], greedy[a] = h[i], best[i]
        if not training:  # eps 0: the reference's draws never explore
            return greedy, Carry(hidden=new_h), {}
        eps = eps_at(cfg, train.steps)
        batch_shape = greedy[ids[0]].shape
        rand, explore = _explore_draws(generator, batch_shape, [num_actions[a] for a in ids],
                                       greedy[ids[0]].device)
        actions = {a: torch.where(explore[i] < eps, rand[i], greedy[a]) for i, a in enumerate(ids)}
        return actions, Carry(hidden=new_h), {"carry_in": carry}

    # ------------------------------------------------------------- trainer

    def loss_fn(params, target_params, win: Transition, carry0: Carry):
        """Double-DQN TD over each window's training suffix, per lane.

        ``win`` is time-major ``(window_len, [S,] B)``; a group's agents
        stack on axis 1.  The target branch and both burn-ins run with no
        gradient.  The mean over agents of each agent's mean squared TD
        error, as in the reference.
        """
        first = win.step_type == StepType.FIRST
        pre, suf = slice(None, cfg.burn_in), slice(cfg.burn_in, None)
        lane = None if win.discount.dim() == 2 else 2  # (T, agents, S, B)
        total = 0.0
        for group in groups:
            k = len(group)
            on = lambda h, xs, rs: q_unroll(params, group, h, xs, rs)
            tg = lambda h, xs, rs: q_unroll(target_params, group, h, xs, rs)
            xs = _agents([win.obs[a] for a in group], 1)
            resets = first.unsqueeze(1).expand(-1, k, *first.shape[1:])
            h0 = _agents([carry0.hidden[a] for a in group], 0)
            h_on, q_on = on(burn_in_carry(on, h0, xs[pre], resets[pre]), xs[suf], resets[suf])
            last_obs = _agents([win.next_obs[a][-1] for a in group], 0)
            with torch.no_grad():
                h_tg, q_tg = tg(burn_in_carry(tg, h0, xs[pre], resets[pre]), xs[suf],
                                resets[suf])
                _, qb_on = q_step(params, group, h_on.detach(), last_obs)
                _, qb_tg = q_step(target_params, group, h_tg, last_obs)
                q_next_on = torch.cat([q_on[1:].detach(), qb_on[None]])
                q_next_tg = torch.cat([q_tg[1:], qb_tg[None]])
                qn = _take(q_next_tg, torch.argmax(q_next_on, dim=-1))
                rewards = _agents([win.rewards[a][suf] for a in group], 1)
                target = rewards + cfg.gamma * win.discount[suf].unsqueeze(1) * qn
            td = _take(q_on, _agents([win.actions[a][suf] for a in group], 1)) - target
            dims = [d for d in range(td.dim()) if d != lane]
            total = total + torch.sum(torch.square(td), dim=dims)
        return total / (len(ids) * cfg.seq_len * win.discount.shape[-1])

    def update(train: TrainState, buffer, generator):
        """One trainer update: sample windows, a TD step, the periodic target sync."""
        win = seq_sample(buffer, generator, cfg.batch_size)  # leaves (T, [S,] B, ...)
        device = win.discount.device
        carry0 = window_start_carry(win.extras, initial_carry, win.discount.shape[1:], device)
        win = win._replace(extras={k: v for k, v in win.extras.items() if k != "carry_in"})
        loss, grads = _value_and_grad(loss_fn, train.params, train.target_params, win, carry0)
        grads = _sync(cfg, grads)
        with torch.no_grad():
            params, opt_state = _apply(opt, grads, train.opt_state, train.params,
                                       lanes.count(generator))
        steps = train.steps + 1
        # the hard sync, decided on the host: params are never written in
        # place, so the targets can share their tensors
        target_params = params if steps % cfg.target_update_period == 0 else train.target_params
        return (TrainState(params, target_params, opt_state, steps), buffer,
                {"loss": loss, "eps": eps_at(cfg, steps)})

    # ------------------------------------------------------------- dataset

    def init_buffer(batch_shape, device):
        """A fresh sequence table for ``batch_shape`` envs (``N``, or ``(S, N)``)."""
        example = _example_transition(spec, {"carry_in": initial_carry((), "cpu")})
        return seq_init(example, cfg.buffer_capacity, window_len, batch_shape, device)

    return System(
        env=env,
        spec=spec,
        init_train=init_train,
        update=update,
        select_actions=select_actions,
        initial_carry=initial_carry,
        init_buffer=init_buffer,
        observe=lambda buf, tr: seq_add(buf, tr, stride=stride),
        can_sample=lambda buf: seq_can_sample(buf, cfg.min_windows),
        updates_per_step=cfg.updates_per_step,
        name="rec_madqn",
    )
