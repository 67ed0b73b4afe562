"""On-policy PPO family: IPPO / MAPPO, feed-forward and recurrent (port of `repro.systems.onpolicy`).

Four variants from two axes, as in the reference:

* critic input: IPPO's critic reads each agent's own observation, MAPPO's
  centralised critic the global env state;
* memory: the feed-forward variants (``ippo`` / ``mappo``) are MLP actors
  and critics; the recurrent ones (``rec_ippo`` / ``rec_mappo``) put a
  memory core between an MLP encoder and each head.  With
  ``recurrent_core="linear"`` every BPTT unroll is one call of the
  recurrent-scan kernel.

Weights are shared across agents when ``shared_weights`` is set and the
env is homogeneous.  The feed-forward update shuffles the flattened
``T * B`` rows each epoch and drops the rows past ``num_minibatches *
mb_size``; the recurrent one shuffles the env axis and re-runs the cores
over the stored window from the carry the executor stored
(``Transition.extras["carry_in"]``), with FIRST-row resets.

Every function also runs seed lanes (`repro_torch.lanes`): given a tuple
of lane generators, params and optimizer state lead with the lane axis,
env-indexed tensors have the batch shape ``(S, N)``, each lane draws its
actions and shuffles from its own generator, and the losses, advantage
normalisation and gradient clipping reduce within a lane.

With ``use_vtrace`` the update swaps GAE for V-trace
(`repro_torch.systems.vtrace`): it re-evaluates the stored trajectory's
log-probs and values under the current params (the recurrent variants
re-run the actor over the window, one more unroll through the memory
core) and importance-weights them against the behaviour log-probs the
executor stored, as the async runner's stale actors need.  With
``distributed_axis`` every minibatch's gradients are averaged over the
ranks bound to that axis (`repro_torch.distributed.collective.pmean`)
before the optimizer step.

Action draws: the reference's ``jax.random.categorical`` cannot be matched
by a torch draw, so actions are Gumbel-max draws from the run's generator;
greedy actions are the same argmax.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch import lanes, optim
from repro_torch.core.buffer import (
    rollout_add,
    rollout_init,
    rollout_ready,
    rollout_reset,
    rollout_take,
)
from repro_torch.core.system import System
from repro_torch.core.types import Carry, TrainState, Transition
from repro_torch.distributed.collective import pmean
from repro_torch.envs.api import EnvSpec, StepType
from repro_torch.nn import MLP
from repro_torch.nn.recurrent import make_core, window_start_carry
from repro_torch.systems.vtrace import vtrace_advantages
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters of the PPO family (same fields and defaults as the reference)."""

    hidden_sizes: Sequence[int] = (64, 64)
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    epochs: int = 4
    num_minibatches: int = 4
    max_grad_norm: float = 0.5
    rollout_len: int = 128
    shared_weights: bool = True
    recurrent_core: str = "gru"
    distributed_axis: str | None = None
    use_vtrace: bool = False
    vtrace_clip_rho: float = 1.0
    vtrace_clip_c: float = 1.0


def _make_gae(cfg: PPOConfig, ids):
    """Per-agent GAE over a time-major (T, B) trajectory (``(T, S, B)`` with seed lanes)."""

    def gae(traj: Transition, last_values):
        """Per-agent advantages and returns for one stored trajectory."""
        adv, ret = {}, {}
        values = traj.extras["value"]
        disc = traj.discount * cfg.gamma
        for a in ids:
            v, r = values[a], traj.rewards[a]
            # The reference's reverse lax.scan (onpolicy.py:113-142) becomes a
            # Python loop over T: a few small launches per step, per agent.
            advs = torch.empty_like(v)
            gae_t, v_next = torch.zeros_like(last_values[a]), last_values[a]
            for t in reversed(range(v.shape[0])):
                delta = r[t] + disc[t] * v_next - v[t]
                gae_t = delta + disc[t] * cfg.gae_lambda * gae_t
                advs[t] = gae_t
                v_next = v[t]
            adv[a] = advs
            ret[a] = advs + v
        return adv, ret

    return gae


def _vtrace(cfg: PPOConfig, ids, traj: Transition, curr_logp, curr_values, last_values):
    """Per-agent V-trace advantages and value targets, in the places GAE's take."""
    adv, ret = {}, {}
    disc = traj.discount * cfg.gamma
    for a in ids:
        adv[a], ret[a] = vtrace_advantages(
            curr_logp[a], traj.extras["logp"][a], curr_values[a], last_values[a],
            traj.rewards[a], disc, clip_rho=cfg.vtrace_clip_rho, clip_c=cfg.vtrace_clip_c,
            lam=cfg.gae_lambda,
        )
    return adv, ret


def _sync(cfg, grads):
    """The gradients averaged over ``cfg.distributed_axis``'s ranks, or as they are without one."""
    return pmean(grads, cfg.distributed_axis) if cfg.distributed_axis else grads


def _ppo_surrogate(cfg: PPOConfig, lp, lp_all, logp_old, adv, v, returns, lane_dim=None):
    """The clipped PPO objective for one agent's batch of rows (any shape).

    With ``lane_dim`` every reduction runs within a lane, over all other
    axes, and the result is the ``(S,)`` per-lane objective.
    """
    dims = None if lane_dim is None else [d for d in range(adv.dim()) if d != lane_dim]
    ratio = torch.exp(lp - logp_old)
    # jnp's adv.std() is the population std (ddof 0); torch.std defaults to
    # ddof 1, hence correction=0
    adv = (adv - adv.mean(dims, keepdim=True)) / (
        adv.std(dims, correction=0, keepdim=True) + 1e-8
    )
    pg = -torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    )
    v_loss = torch.square(v - returns)
    ent = -torch.sum(torch.exp(lp_all) * lp_all, dim=-1)
    return torch.mean(pg + cfg.value_coef * v_loss - cfg.entropy_coef * ent, dims)


def _take(lp_all, actions):
    """``lp_all[..., actions]`` per row (the reference's take_along_axis)."""
    # torch.gather wants int64 indices; actions are stored as int32
    return torch.gather(lp_all, -1, actions.long()[..., None])[..., 0]


def _sample(logits, generator):
    """Categorical draws by the Gumbel-max trick, from ``generator`` (or lane generators)."""
    u = lanes.rand(generator, logits.shape, logits.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _env_permutation(n: int, generator):
    """The env-axis shuffle of one recurrent PPO epoch: ``(n,)``, or ``(S, n)`` per lane."""
    return lanes.randperm(n, generator)


def _row_permutation(n: int, generator):
    """The flattened-row shuffle of one feed-forward PPO epoch: ``(n,)``, or ``(S, n)``."""
    return lanes.randperm(n, generator)


def _pick(x, idx, axis, lane=None):
    """Entries ``idx`` of ``x`` along ``axis``.

    With seed lanes ``idx`` is ``(S, k)``, the lane axis of ``x`` is
    ``axis - 1`` and ``lane`` is ``arange(S)[:, None]``: each lane takes
    its own entries.
    """
    if lane is None:
        return x.index_select(axis, idx)
    return x[(slice(None),) * (axis - 1) + (lane, idx)]


def _value_and_grad(fn, params, *args):
    """``(fn(params, *args), d fn / d params)`` with grads as a params-shaped tree.

    Per-lane losses ``(S,)`` are summed for the backward pass: lanes share
    no parameter, so each lane's gradient is that of its own loss.  A
    parameter the loss does not read gets zeros, as ``jax.grad`` gives it
    (DIAL's message head in its no-channel ablation).
    """
    with torch.enable_grad():
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        loss = fn(p, *args)
        leaves = tree_leaves(p)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss.sum(), leaves,
                                                              materialize_grads=True)))
    return loss.detach(), tree_map(lambda x: grads[id(x)], p)


def _apply(opt, grads, opt_state, params, num_lanes):
    """One optimizer step; with seed lanes, vmapped so clipping norms stay per lane."""
    update = opt.update if num_lanes is None else torch.func.vmap(opt.update)
    updates, opt_state = update(grads, opt_state, params)
    return optim.apply_updates(params, updates), opt_state


def _optimizer(cfg: PPOConfig):
    return optim.chain(
        optim.clip_by_global_norm(cfg.max_grad_norm),
        optim.adamw(cfg.learning_rate),
    )


def _example_transition(spec: EnvSpec, extras):
    """A zero `Transition` fixing the buffer's per-row shapes and dtypes."""
    ids = spec.agent_ids
    obs = {a: torch.zeros(spec.observations[a].shape) for a in ids}
    return Transition(
        obs=obs,
        actions={a: torch.zeros((), dtype=torch.int32) for a in ids},
        rewards={a: torch.zeros(()) for a in ids},
        discount=torch.zeros(()),
        next_obs=obs,
        state=torch.zeros(spec.state.shape),
        next_state=torch.zeros(spec.state.shape),
        extras=extras,
        step_type=torch.zeros((), dtype=torch.int32),
    )


def _shared(spec: EnvSpec, cfg: PPOConfig):
    """Whether agents share weights: asked for, and the env is homogeneous."""
    sigs = {(spec.observations[a].shape[0], spec.actions[a].num_values) for a in spec.agent_ids}
    return cfg.shared_weights and len(sigs) == 1


# ------------------------------------------------------------- feed-forward


def make_ppo_networks(env, cfg: PPOConfig, centralised: bool):
    """Feed-forward per-agent actor/critic MLPs (shared if homogeneous).

    Returns ``(ids, num_actions, init, logits, value)``.
    """
    spec: EnvSpec = env.spec()
    ids = list(spec.agent_ids)
    num_actions = {a: spec.actions[a].num_values for a in ids}
    obs_dims = {a: spec.observations[a].shape[0] for a in ids}
    share = _shared(spec, cfg)

    actors = {a: MLP((obs_dims[a], *cfg.hidden_sizes, num_actions[a])) for a in ids}
    critic_in = {a: (spec.state.shape[0] if centralised else obs_dims[a]) for a in ids}
    critics = {a: MLP((critic_in[a], *cfg.hidden_sizes, 1)) for a in ids}

    def init(generator):
        """Initialise actor/critic params (shared across agents if homogeneous)."""
        if share:
            return {
                "actor": {"shared": actors[ids[0]].init(generator)},
                "critic": {"shared": critics[ids[0]].init(generator)},
            }
        return {
            "actor": {a: actors[a].init(generator) for a in ids},
            "critic": {a: critics[a].init(generator) for a in ids},
        }

    def logits(params, agent, obs):
        """Actor logits for one agent's observation batch."""
        p = params["actor"]["shared"] if share else params["actor"][agent]
        return actors[agent].apply(p, obs)

    def value(params, agent, critic_obs):
        """Critic value for one agent's (obs or state) batch."""
        p = params["critic"]["shared"] if share else params["critic"][agent]
        return critics[agent].apply(p, critic_obs)[..., 0]

    return ids, num_actions, init, logits, value


def make_ppo_system(env, cfg: PPOConfig, centralised: bool, name: str) -> System:
    """Build a feed-forward PPO `System` (IPPO or MAPPO by critic input)."""
    spec: EnvSpec = env.spec()
    ids, num_actions, init_params, logits_fn, value_fn = make_ppo_networks(
        env, cfg, centralised
    )
    opt = _optimizer(cfg)

    def critic_obs(obs, state, agent):
        """The critic input: global state (MAPPO) or own obs (IPPO)."""
        return state if centralised else obs[agent]

    def init_train(generator):
        """Initialise the `TrainState` on ``generator``'s device."""
        params = init_params(generator)
        steps = torch.zeros((), dtype=torch.int32, device=generator.device)
        return TrainState(params, params, opt.init(params), steps)

    # ------------------------------------------------------------ executor

    def select_actions(train: TrainState, obs, state, carry, generator, training=True):
        """Sample actions; log-probs and values ride along in extras."""
        params = train.params
        if not training:
            actions = {
                a: torch.argmax(logits_fn(params, a, obs[a]), dim=-1).to(torch.int32)
                for a in ids
            }
            return actions, carry, {}
        actions, logps, values = {}, {}, {}
        for a in ids:
            lg = logits_fn(params, a, obs[a])
            act = _sample(lg, generator)
            logps[a] = _take(torch.log_softmax(lg, dim=-1), act)
            actions[a] = act.to(torch.int32)
            values[a] = value_fn(params, a, critic_obs(obs, state, a))
        return actions, carry, {"logp": logps, "value": values}

    def initial_carry(batch_shape, device):
        """Feed-forward executors keep no memory."""
        del batch_shape, device
        return ()

    # ------------------------------------------------------------- trainer

    gae = _make_gae(cfg, ids)

    def loss_fn(params, mb, lane_dim):
        """Summed per-agent clipped PPO surrogate over one minibatch."""
        total = 0.0
        for a in ids:
            lp_all = torch.log_softmax(logits_fn(params, a, mb["obs"][a]), dim=-1)
            lp = _take(lp_all, mb["actions"][a])
            v = value_fn(params, a, critic_obs(mb["obs"], mb["state"], a))
            total = total + _ppo_surrogate(
                cfg, lp, lp_all, mb["logp"][a], mb["advantage"][a], v, mb["returns"][a],
                lane_dim,
            )
        return total

    def update(train: TrainState, buffer, generator):
        """Consume the rollout: GAE or V-trace, then epochs of shuffled row minibatches."""
        traj: Transition = rollout_take(buffer)  # leaves (T, [S,] B, ...)
        S = lanes.count(generator)
        T, B = traj.discount.shape[0], traj.discount.shape[-1]
        with torch.no_grad():
            last_obs = tree_map(lambda x: x[-1], traj.next_obs)
            last_state = traj.next_state[-1]
            last_values = {
                a: value_fn(train.params, a, critic_obs(last_obs, last_state, a)) for a in ids
            }
            if cfg.use_vtrace:
                # the stored trajectory under the current params
                curr_logp = {
                    a: _take(torch.log_softmax(logits_fn(train.params, a, traj.obs[a]), dim=-1),
                             traj.actions[a])
                    for a in ids
                }
                curr_values = {
                    a: value_fn(train.params, a, critic_obs(traj.obs, traj.state, a)) for a in ids
                }
                adv, ret = _vtrace(cfg, ids, traj, curr_logp, curr_values, last_values)
            else:
                adv, ret = gae(traj, last_values)
        data = dict(
            obs=traj.obs,
            state=traj.state,
            actions=traj.actions,
            logp=traj.extras["logp"],
            advantage=adv,
            returns=ret,
        )
        # time-major rows, as the reference flattens (T, B): ([S,] T * B, ...)
        if S is None:
            flat = tree_map(lambda x: x.reshape(T * B, *x.shape[2:]), data)
            lane = None
        else:
            flat = tree_map(lambda x: x.movedim(1, 0).reshape(S, T * B, *x.shape[3:]), data)
            lane = torch.arange(S, device=traj.discount.device)[:, None]
        # the rows past num_minibatches * mb_size sit out the epoch, as in the reference
        mb_size = (T * B) // cfg.num_minibatches
        params, opt_state = train.params, train.opt_state
        losses = []
        for _ in range(cfg.epochs):
            perm = _row_permutation(T * B, generator)
            for i in range(cfg.num_minibatches):
                idx = perm[..., i * mb_size : (i + 1) * mb_size]
                mb = tree_map(lambda x: _pick(x, idx, 0 if S is None else 1, lane), flat)
                loss, grads = _value_and_grad(loss_fn, params, mb, None if S is None else 0)
                grads = _sync(cfg, grads)
                with torch.no_grad():
                    params, opt_state = _apply(opt, grads, opt_state, params, S)
                losses.append(loss)
        new_train = TrainState(params, params, opt_state, train.steps + 1)
        return new_train, rollout_reset(buffer), {"loss": torch.stack(losses).mean(0)}

    # ------------------------------------------------------------- dataset

    def init_buffer(batch_shape, device):
        """A fresh rollout buffer for ``batch_shape`` envs (``N``, or ``(S, N)``)."""
        zeros = {a: torch.zeros(()) for a in ids}
        example = _example_transition(spec, {"logp": zeros, "value": dict(zeros)})
        return rollout_init(example, cfg.rollout_len, batch_shape, device)

    return System(
        env=env,
        spec=spec,
        init_train=init_train,
        update=update,
        select_actions=select_actions,
        initial_carry=initial_carry,
        init_buffer=init_buffer,
        observe=rollout_add,
        can_sample=lambda buf: rollout_ready(buf, cfg.rollout_len),
        name=name,
    )


# --------------------------------------------------------------- recurrent


def make_recurrent_ppo_networks(env, cfg: PPOConfig, centralised: bool = False):
    """Per-agent recurrent actor/critic stacks (encoder -> core -> head).

    The actor reads the agent's own observation; the critic reads it too
    (rec-IPPO) or, ``centralised``, the global state (rec-MAPPO).

    Returns ``(ids, num_actions, init, actor, critic)``; ``actor`` and
    ``critic`` expose ``step`` (one env step) and ``unroll`` (BPTT over a
    stored window with FIRST-row resets).
    """
    spec: EnvSpec = env.spec()
    ids = list(spec.agent_ids)
    num_actions = {a: spec.actions[a].num_values for a in ids}
    obs_dims = {a: spec.observations[a].shape[0] for a in ids}
    hidden = cfg.hidden_sizes[-1]
    share = _shared(spec, cfg)
    critic_in = {a: (spec.state.shape[0] if centralised else obs_dims[a]) for a in ids}

    def stack(in_dim, out_dim):
        return {
            "encoder": MLP((in_dim, *cfg.hidden_sizes), activate_final=True),
            "core": make_core(cfg.recurrent_core, hidden, hidden),
            "head": MLP((hidden, out_dim)),
        }

    actors = {a: stack(obs_dims[a], num_actions[a]) for a in ids}
    critics = {a: stack(critic_in[a], 1) for a in ids}

    def init_stack(net, generator):
        return {k: net[k].init(generator) for k in ("encoder", "core", "head")}

    def init(generator):
        """Initialise actor/critic stacks (shared across agents if homogeneous)."""
        if share:
            return {
                "actor": {"shared": init_stack(actors[ids[0]], generator)},
                "critic": {"shared": init_stack(critics[ids[0]], generator)},
            }
        return {
            "actor": {a: init_stack(actors[a], generator) for a in ids},
            "critic": {a: init_stack(critics[a], generator) for a in ids},
        }

    class _Net:
        """step/unroll faces of one recurrent network family (actor or critic)."""

        def __init__(self, nets, group):
            self.nets, self.group = nets, group

        def _p(self, params, agent):
            sub = params[self.group]
            return sub["shared"] if share else sub[agent]

        def step(self, params, agent, h, x, reset=None):
            """One act-time step: ``(h, x) -> (h, head_output)``."""
            net, p = self.nets[agent], self._p(params, agent)
            z = net["encoder"].apply(p["encoder"], x)
            h, y = net["core"].step(p["core"], h, z, reset)
            return h, net["head"].apply(p["head"], y)

        def unroll(self, params, agent, h, xs, resets):
            """BPTT over ``(T, B, ...)`` inputs with FIRST-row resets."""
            net, p = self.nets[agent], self._p(params, agent)
            z = net["encoder"].apply(p["encoder"], xs)
            h, ys = net["core"].unroll(p["core"], h, z, resets)
            return h, net["head"].apply(p["head"], ys)

    return ids, num_actions, init, _Net(actors, "actor"), _Net(critics, "critic")


def make_recurrent_ppo_system(env, cfg: PPOConfig, centralised: bool, name: str) -> System:
    """Build a recurrent PPO `System` (rec-IPPO or rec-MAPPO by critic input)."""
    spec: EnvSpec = env.spec()
    ids, num_actions, init_params, actor, critic = make_recurrent_ppo_networks(
        env, cfg, centralised
    )
    hidden = cfg.hidden_sizes[-1]
    opt = _optimizer(cfg)

    def critic_obs(obs, state, agent):
        """The critic input: global state (rec-MAPPO) or own obs (rec-IPPO)."""
        return state if centralised else obs[agent]

    def init_train(generator):
        """Initialise the `TrainState` on ``generator``'s device."""
        params = init_params(generator)
        steps = torch.zeros((), dtype=torch.int32, device=generator.device)
        return TrainState(params, params, opt.init(params), steps)

    def initial_carry(batch_shape, device):
        """The executor's zero memory for a ``batch_shape`` of envs."""
        zeros = lambda: {a: torch.zeros(*batch_shape, hidden, device=device) for a in ids}
        return Carry(hidden={"actor": zeros(), "critic": zeros()})

    # ------------------------------------------------------------ executor

    def select_actions(train: TrainState, obs, state, carry, generator, training=True):
        """One recurrent act step; the incoming carry rides in extras["carry_in"]."""
        params = train.params
        h_actor, h_critic = dict(carry.hidden["actor"]), dict(carry.hidden["critic"])
        if not training:
            actions = {}
            for a in ids:
                h_actor[a], lg = actor.step(params, a, h_actor[a], obs[a])
                actions[a] = torch.argmax(lg, dim=-1).to(torch.int32)
            return actions, Carry(hidden={"actor": h_actor, "critic": h_critic}), {}
        actions, logps, values = {}, {}, {}
        for a in ids:
            h_actor[a], lg = actor.step(params, a, h_actor[a], obs[a])
            act = _sample(lg, generator)
            logps[a] = _take(torch.log_softmax(lg, dim=-1), act)
            actions[a] = act.to(torch.int32)
            h_critic[a], v = critic.step(params, a, h_critic[a], critic_obs(obs, state, a))
            values[a] = v[..., 0]
        new_carry = Carry(hidden={"actor": h_actor, "critic": h_critic})
        return actions, new_carry, {"logp": logps, "value": values, "carry_in": carry}

    # ------------------------------------------------------------- trainer

    gae = _make_gae(cfg, ids)

    def loss_fn(params, mb, lane_dim):
        """PPO loss over full-length sequences (one BPTT re-run per net)."""
        total = 0.0
        resets = mb["resets"]
        for a in ids:
            h0 = mb["carry0"].hidden["actor"][a]
            _, lg = actor.unroll(params, a, h0, mb["obs"][a], resets)
            lp_all = torch.log_softmax(lg, dim=-1)
            lp = _take(lp_all, mb["actions"][a])
            hc0 = mb["carry0"].hidden["critic"][a]
            _, v = critic.unroll(params, a, hc0, critic_obs(mb["obs"], mb["state"], a), resets)
            total = total + _ppo_surrogate(
                cfg, lp, lp_all, mb["logp"][a], mb["advantage"][a], v[..., 0],
                mb["returns"][a], lane_dim,
            )
        return total

    def update(train: TrainState, buffer, generator):
        """Consume the rollout: GAE or V-trace, then epochs of sequence minibatches."""
        traj: Transition = rollout_take(buffer)  # leaves (T, [S,] B, ...)
        S = lanes.count(generator)
        B = traj.discount.shape[-1]
        device = traj.discount.device
        resets = traj.step_type == StepType.FIRST
        carry0 = window_start_carry(traj.extras, initial_carry, traj.discount.shape[1:], device)

        # Bootstrap value at T: replay the critic cores over the window from
        # the stored start carry, then one step on the final next-observation.
        last_obs = tree_map(lambda x: x[-1], traj.next_obs)
        last_state = traj.next_state[-1]
        last_values, curr_values = {}, {}
        with torch.no_grad():
            for a in ids:
                h_t, v_seq = critic.unroll(
                    train.params, a, carry0.hidden["critic"][a],
                    critic_obs(traj.obs, traj.state, a), resets,
                )
                _, v = critic.step(train.params, a, h_t, critic_obs(last_obs, last_state, a))
                last_values[a], curr_values[a] = v[..., 0], v_seq[..., 0]
            if cfg.use_vtrace:
                # current log-probs: an actor re-run over the stored window
                curr_logp = {}
                for a in ids:
                    _, lg = actor.unroll(train.params, a, carry0.hidden["actor"][a],
                                         traj.obs[a], resets)
                    curr_logp[a] = _take(torch.log_softmax(lg, dim=-1), traj.actions[a])
                adv, ret = _vtrace(cfg, ids, traj, curr_logp, curr_values, last_values)
            else:
                adv, ret = gae(traj, last_values)

        data = dict(
            obs=traj.obs,
            state=traj.state,
            actions=traj.actions,
            logp=traj.extras["logp"],
            advantage=adv,
            returns=ret,
            resets=resets,
        )
        # shuffle and split the env axis, keep time intact; n_mb is the
        # largest divisor of B up to cfg.num_minibatches
        n_mb = max(m for m in range(1, min(cfg.num_minibatches, B) + 1) if B % m == 0)
        mb_size = B // n_mb
        env_axis = 1 if S is None else 2
        lane = None if S is None else torch.arange(S, device=device)[:, None]
        params, opt_state = train.params, train.opt_state
        losses = []
        for _ in range(cfg.epochs):
            perm = _env_permutation(B, generator)
            for i in range(n_mb):
                idx = perm[..., i * mb_size : (i + 1) * mb_size]
                mb = tree_map(lambda x: _pick(x, idx, env_axis, lane), data)
                mb["carry0"] = tree_map(lambda x: _pick(x, idx, env_axis - 1, lane), carry0)
                loss, grads = _value_and_grad(loss_fn, params, mb, None if S is None else 1)
                grads = _sync(cfg, grads)
                with torch.no_grad():
                    params, opt_state = _apply(opt, grads, opt_state, params, S)
                losses.append(loss)
        new_train = TrainState(params, params, opt_state, train.steps + 1)
        return new_train, rollout_reset(buffer), {"loss": torch.stack(losses).mean(0)}

    # ------------------------------------------------------------- dataset

    def init_buffer(batch_shape, device):
        """A fresh rollout buffer for ``batch_shape`` envs (``N``, or ``(S, N)``)."""
        zeros = {a: torch.zeros(()) for a in ids}
        extras = {"logp": zeros, "value": dict(zeros), "carry_in": initial_carry((), "cpu")}
        return rollout_init(_example_transition(spec, extras), cfg.rollout_len, batch_shape,
                            device)

    return System(
        env=env,
        spec=spec,
        init_train=init_train,
        update=update,
        select_actions=select_actions,
        initial_carry=initial_carry,
        init_buffer=init_buffer,
        observe=rollout_add,
        can_sample=lambda buf: rollout_ready(buf, cfg.rollout_len),
        name=name,
    )


# ------------------------------------------------------------ constructors


def make_ippo(env, cfg: PPOConfig = PPOConfig()) -> System:
    """Feed-forward IPPO: decentralised MLP critics on each agent's obs."""
    return make_ppo_system(env, cfg, centralised=False, name="ippo")


def make_mappo(env, cfg: PPOConfig = PPOConfig()) -> System:
    """Feed-forward MAPPO: centralised MLP critics on the global state."""
    return make_ppo_system(env, cfg, centralised=True, name="mappo")


def make_rec_ippo(env, cfg: PPOConfig = PPOConfig()) -> System:
    """Recurrent IPPO: memory-core actors/critics on each agent's obs stream."""
    return make_recurrent_ppo_system(env, cfg, centralised=False, name="rec_ippo")


def make_rec_mappo(env, cfg: PPOConfig = PPOConfig()) -> System:
    """Recurrent MAPPO: memory-core actors, centralised memory-core critics on state."""
    return make_recurrent_ppo_system(env, cfg, centralised=True, name="rec_mappo")
