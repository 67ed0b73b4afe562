"""Greedy-policy evaluation (port of `repro.eval.evaluator`).

Episodes are fixed-length loops of ``env.horizon`` steps across
``num_envs`` batched env copies, with rewards masked after an env's first
LAST step (no auto-reset: each env copy plays exactly one episode).
Actions are greedy (``training=False``), and recurrent carries start at
zero and are threaded across the episode.  The evaluator composes both
ways, as in the reference:

  * standalone: ``evaluate(system, params, seed, ...)``;
  * interleaved: ``make_evaluator(system, ...)`` returns the same function
    of ``(train_or_params, seed)``, which `repro_torch.core.make_anakin`
    calls between blocks of training iterations.

Seed lanes (`repro_torch.lanes`): params that lead with a ``(S,)`` lane
axis and a sequence of ``S`` seeds evaluate every lane in one batch, each
lane's env resets drawn from its own generator; every `EvalMetrics` leaf
then leads with the lane axis.
"""
from __future__ import annotations

import math

import torch

from repro_torch import lanes, resolve_device
from repro_torch.core.types import EvalMetrics, TrainState
from repro_torch.envs.api import StepType
from repro_torch.tree import tree_leaves


def _as_train_state(params_or_train) -> TrainState:
    """Accept a full TrainState or bare params (then wrapped with update count 0)."""
    if isinstance(params_or_train, TrainState):
        return params_or_train
    return TrainState(params_or_train, params_or_train, None, 0)


def _episode_batch(system, train: TrainState, generator, num_envs: int, horizon: int):
    """Roll one batch of ``num_envs`` complete greedy episodes (per lane with lanes)."""
    env = system.env
    ids = list(system.spec.agent_ids)
    S = lanes.count(generator)
    device = lanes.device(generator)
    batch = (num_envs,) if S is None else (S, num_envs)
    env_state, ts = env.reset(math.prod(batch), device, generator)
    carry = system.initial_carry(batch, device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    rets = {a: torch.zeros(batch, device=device) for a in ids}
    length = torch.zeros(batch, dtype=torch.int32, device=device)
    for _ in range(horizon):
        gs = lanes.split(env.global_state(env_state), S)
        actions, carry, _ = system.select_actions(
            train, lanes.split(ts.observation, S), gs, carry, generator, training=False
        )
        env_state, ts = env.step(env_state, lanes.merge(actions, S))
        step = lanes.split(ts, S)
        alive = ~done
        rets = {a: rets[a] + torch.where(alive, step.reward[a], 0.0) for a in ids}
        length = length + alive.to(torch.int32)
        done = done | (step.step_type == StepType.LAST)
    team = torch.mean(torch.stack([rets[a] for a in ids]), dim=0)
    return team, rets, length


def make_evaluator(system, num_episodes: int = 32, num_envs: int = 16):
    """Build the eval function ``(train_or_params, seed) -> EvalMetrics``.

    Episodes run in ``ceil(num_episodes / num_envs)`` rounds of
    ``min(num_envs, num_episodes)`` env copies, all drawing their resets
    from one generator seeded with ``seed``; the overshoot of the last
    round is trimmed, so every leaf has ``num_episodes`` rows.  A sequence
    of seeds with lane params evaluates every lane at once.
    """
    if num_episodes < 1 or num_envs < 1:
        raise ValueError(
            f"num_episodes ({num_episodes}) and num_envs ({num_envs}) must be >= 1"
        )
    num_envs = min(num_envs, num_episodes)
    num_rounds = math.ceil(num_episodes / num_envs)
    ids = list(system.spec.agent_ids)
    horizon = int(system.env.horizon)

    def eval_fn(train_or_params, seed) -> EvalMetrics:
        """The evaluator: ``(train_or_params, seed) -> EvalMetrics``."""
        train = _as_train_state(train_or_params)
        device = tree_leaves(train.params)[0].device
        if isinstance(seed, int):
            generator = torch.Generator(device).manual_seed(seed)
        else:
            generator = lanes.generators(seed, device)
        with torch.no_grad():
            rounds = [
                _episode_batch(system, train, generator, num_envs, horizon)
                for _ in range(num_rounds)
            ]
        # (rounds x num_envs) episodes along the last axis, overshoot trimmed
        flat = lambda xs: torch.cat(xs, -1)[..., :num_episodes]
        return EvalMetrics(
            episode_return=flat([r[0] for r in rounds]),
            agent_returns={a: flat([r[1][a] for r in rounds]) for a in ids},
            episode_length=flat([r[2] for r in rounds]),
        )

    return eval_fn


def evaluate(
    system,
    params,
    seed=0,
    num_episodes: int = 32,
    num_envs: int = 16,
    num_seeds=None,
    device=None,
) -> EvalMetrics:
    """Greedy evaluation of ``params`` (a TrainState or bare params) on ``device``.

    The same ``(params, seed)`` gives the same returns, and matches the
    interleaved evaluator built with the same ``(num_episodes, num_envs)``.
    With ``num_seeds``, ``params`` lead with a ``(num_seeds,)`` lane axis
    and ``seed`` is a sequence of ``num_seeds`` seeds: every lane evaluates
    in one batch and every `EvalMetrics` leaf gains that axis.
    """
    device = resolve_device(device)
    eval_fn = make_evaluator(system, num_episodes, num_envs)
    if num_seeds is not None:
        train = _as_train_state(params)
        sizes = {x.shape[0] if x.dim() else None for x in tree_leaves(train.params)}
        if isinstance(seed, int) or len(seed) != num_seeds or sizes != {num_seeds}:
            raise ValueError(
                f"num_seeds={num_seeds} needs that many seeds and params with that "
                f"leading axis; got seed {seed!r} and leading sizes {sorted(sizes, key=str)}"
            )
    elif not isinstance(seed, int):
        raise ValueError("a sequence of seeds needs num_seeds")
    kinds = {x.device.type for x in tree_leaves(_as_train_state(params).params)}
    if kinds != {device.type}:
        raise ValueError(f"params lie on {kinds}, the evaluation runs on {device}")
    return eval_fn(params, seed)
