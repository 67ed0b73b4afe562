"""Recurrent PPO on the memory-core protocol (port of `repro.systems.onpolicy`).

This slice ports the recurrent variants: per-agent encoder -> memory core
-> head actors and critics, weights shared across agents when the env is
homogeneous, the executor storing its incoming carry per step in
``Transition.extras["carry_in"]``, and an update that re-runs the cores
over the stored window from that carry (BPTT with FIRST-row resets),
minibatching over the env axis.  With ``recurrent_core="linear"`` every
BPTT unroll is one call of the recurrent-scan kernel.

V-trace (``use_vtrace``), the centralised critic of rec-MAPPO and the
feed-forward variants are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch import optim
from repro_torch.core.buffer import (
    rollout_add,
    rollout_init,
    rollout_ready,
    rollout_reset,
    rollout_take,
)
from repro_torch.core.system import System
from repro_torch.core.types import Carry, TrainState, Transition
from repro_torch.envs.api import EnvSpec, StepType
from repro_torch.nn import MLP
from repro_torch.nn.recurrent import make_core, window_start_carry
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
    use_vtrace: bool = False  # not ported: True raises


def _make_gae(cfg: PPOConfig, ids):
    """Per-agent GAE over a time-major (T, B) trajectory."""

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


def _ppo_surrogate(cfg: PPOConfig, lp, lp_all, logp_old, adv, v, returns):
    """The clipped PPO objective for one agent's batch of rows (any shape)."""
    ratio = torch.exp(lp - logp_old)
    # jnp's adv.std() is the population std (ddof 0); torch.std defaults to
    # ddof 1, hence correction=0
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    )
    v_loss = torch.square(v - returns)
    ent = -torch.sum(torch.exp(lp_all) * lp_all, dim=-1)
    return torch.mean(pg + cfg.value_coef * v_loss - cfg.entropy_coef * ent)


def _take(lp_all, actions):
    """``lp_all[..., actions]`` per row (the reference's take_along_axis)."""
    # torch.gather wants int64 indices; actions are stored as int32
    return torch.gather(lp_all, -1, actions.long()[..., None])[..., 0]


def _sample(logits, generator):
    """Categorical draws by the Gumbel-max trick, from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _env_permutation(n: int, generator):
    """The env-axis shuffle of one PPO epoch."""
    return torch.randperm(n, generator=generator, device=generator.device)


def _value_and_grad(fn, params, *args):
    """``(fn(params, *args), d fn / d params)`` with grads as a params-shaped tree."""
    with torch.enable_grad():
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        loss = fn(p, *args)
        leaves = tree_leaves(p)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda x: grads[id(x)], p)


def make_recurrent_ppo_networks(env, cfg: PPOConfig):
    """Per-agent recurrent actor/critic stacks (encoder -> core -> head).

    Both stacks read the agent's own observation (rec-IPPO's critic).

    Returns ``(ids, num_actions, init, actor, critic)``; ``actor`` and
    ``critic`` expose ``step`` (one env step) and ``unroll`` (BPTT over a
    stored window with FIRST-row resets).
    """
    spec: EnvSpec = env.spec()
    ids = list(spec.agent_ids)
    num_actions = {a: spec.actions[a].num_values for a in ids}
    obs_dims = {a: spec.observations[a].shape[0] for a in ids}
    hidden = cfg.hidden_sizes[-1]

    homogeneous = len(set((obs_dims[a], num_actions[a]) for a in ids)) == 1
    share = cfg.shared_weights and homogeneous

    def stack(in_dim, out_dim):
        return {
            "encoder": MLP((in_dim, *cfg.hidden_sizes), activate_final=True),
            "core": make_core(cfg.recurrent_core, hidden, hidden),
            "head": MLP((hidden, out_dim)),
        }

    actors = {a: stack(obs_dims[a], num_actions[a]) for a in ids}
    critics = {a: stack(obs_dims[a], 1) for a in ids}

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


def make_recurrent_ppo_system(env, cfg: PPOConfig, name: str) -> System:
    """Build a recurrent PPO `System` with per-agent-observation critics."""
    if cfg.use_vtrace:
        raise NotImplementedError("V-trace is not ported yet")
    spec: EnvSpec = env.spec()
    ids, num_actions, init_params, actor, critic = make_recurrent_ppo_networks(env, cfg)
    hidden = cfg.hidden_sizes[-1]
    opt = optim.chain(
        optim.clip_by_global_norm(cfg.max_grad_norm),
        optim.adamw(cfg.learning_rate),
    )

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
            h_critic[a], v = critic.step(params, a, h_critic[a], obs[a])
            values[a] = v[..., 0]
        new_carry = Carry(hidden={"actor": h_actor, "critic": h_critic})
        return actions, new_carry, {"logp": logps, "value": values, "carry_in": carry}

    # ------------------------------------------------------------- trainer

    gae = _make_gae(cfg, ids)

    def loss_fn(params, mb):
        """PPO loss over full-length sequences (one BPTT re-run per net)."""
        total = 0.0
        resets = mb["resets"]
        for a in ids:
            h0 = mb["carry0"].hidden["actor"][a]
            _, lg = actor.unroll(params, a, h0, mb["obs"][a], resets)
            lp_all = torch.log_softmax(lg, dim=-1)
            lp = _take(lp_all, mb["actions"][a])
            hc0 = mb["carry0"].hidden["critic"][a]
            _, v = critic.unroll(params, a, hc0, mb["obs"][a], resets)
            total = total + _ppo_surrogate(
                cfg, lp, lp_all, mb["logp"][a], mb["advantage"][a], v[..., 0],
                mb["returns"][a],
            )
        return total

    def update(train: TrainState, buffer, generator):
        """Consume the rollout: GAE, then epochs of sequence minibatches."""
        traj: Transition = rollout_take(buffer)  # leaves (T, B, ...)
        T, B = traj.discount.shape
        device = traj.discount.device
        resets = traj.step_type == StepType.FIRST
        carry0 = window_start_carry(traj.extras, initial_carry, (B,), device)

        # Bootstrap value at T: replay the critic cores over the window from
        # the stored start carry, then one step on the final next-observation.
        last_values = {}
        with torch.no_grad():
            for a in ids:
                h_t, _ = critic.unroll(
                    train.params, a, carry0.hidden["critic"][a], traj.obs[a], resets
                )
                _, v = critic.step(train.params, a, h_t, traj.next_obs[a][-1])
                last_values[a] = v[..., 0]
            adv, ret = gae(traj, last_values)

        data = dict(
            obs=traj.obs,
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
        params, opt_state = train.params, train.opt_state
        losses = []
        for _ in range(cfg.epochs):
            perm = _env_permutation(B, generator)
            for i in range(n_mb):
                idx = perm[i * mb_size : (i + 1) * mb_size]
                mb = tree_map(lambda x: x[:, idx], data)
                mb["carry0"] = tree_map(lambda x: x[idx], carry0)
                loss, grads = _value_and_grad(loss_fn, params, mb)
                with torch.no_grad():
                    updates, opt_state = opt.update(grads, opt_state, params)
                    params = optim.apply_updates(params, updates)
                losses.append(loss)
        new_train = TrainState(params, params, opt_state, train.steps + 1)
        return new_train, rollout_reset(buffer), {"loss": torch.stack(losses).mean()}

    # ------------------------------------------------------------- dataset

    def example_transition():
        """A zero `Transition` fixing the buffer's per-row shapes and dtypes."""
        obs = {a: torch.zeros(spec.observations[a].shape) for a in ids}
        scalars = {a: torch.zeros(()) for a in ids}
        return Transition(
            obs=obs,
            actions={a: torch.zeros((), dtype=torch.int32) for a in ids},
            rewards=dict(scalars),
            discount=torch.zeros(()),
            next_obs=obs,
            state=torch.zeros(spec.state.shape),
            next_state=torch.zeros(spec.state.shape),
            extras={
                "logp": dict(scalars),
                "value": dict(scalars),
                "carry_in": initial_carry((), "cpu"),
            },
            step_type=torch.zeros((), dtype=torch.int32),
        )

    def init_buffer(num_envs: int, device):
        """A fresh rollout buffer for ``num_envs`` parallel envs."""
        return rollout_init(example_transition(), cfg.rollout_len, num_envs, device)

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


def make_rec_ippo(env, cfg: PPOConfig = PPOConfig()) -> System:
    """Recurrent IPPO: memory-core actors/critics on each agent's obs stream."""
    return make_recurrent_ppo_system(env, cfg, name="rec_ippo")
