"""The `System` abstraction and its runners (port of `repro.core.system`).

A System bundles the executor (``select_actions`` + carry), the trainer
(``update``) and the dataset (buffer) as plain functions on tensors, as in
the reference.  Three runners here drive it (the fourth, the async
actor/learner runner, is `repro_torch.distributed.impala`):

  run_environment_loop — the paper's Block-1 executor-environment loop:
      one env, python-paced, the faithful baseline;
  train_anakin — every env copy in one batch: act, env step and rollout
      write for all copies per iteration, and the trainer update whenever
      the dataset is ready.  The reference fuses this into one
      ``lax.scan`` under ``jit``; here it is a Python loop of batched
      tensor ops, and the ``lax.cond`` update gate is a Python ``if`` on a
      Python int.  With ``num_seeds`` the runs of several seeds share every
      op as seed lanes (`repro_torch.lanes`), and with ``eval_every`` the
      greedy evaluator runs between blocks of iterations;
  train_distributed — the paper's ``num_executors``: one process a rank on
      ``torch.distributed``, each running anakin on its own envs and
      dataset, with a system built with ``distributed_axis="data"``
      averaging its gradients across the ranks in every update.  Where
      the reference's ``shard_map`` splits one key, each rank here starts
      from its own seed, so the ranks' initial params differ (as the
      reference's do: its per-device init splits the train key per
      device); the averaged gradients then move them in step.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import torch

from repro_torch import lanes, resolve_device
from repro_torch.core.types import EvalMetrics, SystemState, TrainState, Transition
from repro_torch.envs.api import StepType
from repro_torch.envs.wrappers import AutoReset, EpisodeStats, replace_reset_keys
from repro_torch.nn.recurrent import reset_carry
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class System:
    """A full MARL algorithm specification (executor + trainer + dataset).

    Signatures (``generator`` is a `torch.Generator` on the run's device):

    * ``init_train(generator) -> TrainState``
    * ``update(train, buffer, generator) -> (train, buffer, metrics)``
    * ``select_actions(train, obs, state, carry, generator, training)
      -> (actions, carry, extras)``
    * ``initial_carry(batch_shape, device) -> carry``
    * ``init_buffer(batch_shape, device)``, ``observe(buffer, transition)``,
      ``can_sample(buffer) -> bool``

    ``update`` and ``select_actions`` also take a tuple of lane generators
    with seed-lane tensors (`repro_torch.lanes`); ``batch_shape`` is then
    ``(S, N)``.

    The dataset is a replay table (`repro_torch.core.buffer.BufferState`:
    ``can_sample`` gates on its fill and ``update`` samples it, leaving it
    as it is) or a rollout (``can_sample`` fires when the rollout is
    complete and ``update`` consumes and resets it).  Each ready iteration
    runs ``updates_per_step`` updates.  ``action_space`` is the action
    regime the algorithm supports, ``"discrete"`` or ``"continuous"``.
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
    updates_per_step: int = 1
    name: str = "system"
    action_space: str = "discrete"


def _training_env(env):
    """The runner-side wrapper stack: episode stats over fused auto-reset."""
    return EpisodeStats(AutoReset(env))


def _team_return(last_returns):
    """Mean-over-agents of the per-agent completed-episode returns."""
    return torch.mean(torch.stack(list(last_returns.values())), dim=0)


# ------------------------------------------------------ faithful python loop


def run_environment_loop(
    system: System,
    seed: int,
    num_episodes: int = 10,
    training: bool = True,
    train_state=None,
    buffer_state=None,
    device=None,
):
    """The paper's Block-1 executor-environment loop: one env, python-paced.

    The env is a batch of one, stepped until its episode's LAST; in
    ``training`` mode every transition goes to the dataset and the trainer
    updates whenever it is ready.  Randomness comes from one generator
    seeded with ``seed``.  Returns ``(train_state, buffer_state,
    EvalMetrics over the episodes)``: per-agent and team (mean over agents)
    undiscounted returns, accumulated by the `EpisodeStats` wrapper.
    """
    device = resolve_device(device)
    env = EpisodeStats(system.env)
    ids = list(system.spec.agent_ids)
    generator = torch.Generator(device).manual_seed(seed)
    if train_state is None:
        train_state = system.init_train(generator)
    if buffer_state is None:
        buffer_state = system.init_buffer(1, device)

    team, lengths, agent_returns = [], [], {a: [] for a in ids}
    for _ in range(num_episodes):
        env_state, ts = env.reset(1, device, generator)
        carry = system.initial_carry((1,), device)
        while int(ts.step_type[0]) != StepType.LAST:
            obs = ts.observation
            gs = env.global_state(env_state)
            with torch.no_grad():
                actions, carry, extras = system.select_actions(
                    train_state, obs, gs, carry, generator, training=training
                )
            new_env_state, new_ts = env.step(env_state, actions)
            if training:
                tr = Transition(
                    obs=obs,
                    actions=actions,
                    rewards=new_ts.reward,
                    discount=new_ts.discount,
                    next_obs=new_ts.observation,
                    state=gs,
                    next_state=env.global_state(new_env_state),
                    extras=extras,
                    step_type=ts.step_type,
                )
                buffer_state = system.observe(buffer_state, tr)
                if system.can_sample(buffer_state):
                    train_state, buffer_state, _ = system.update(
                        train_state, buffer_state, generator
                    )
            env_state, ts = new_env_state, new_ts
        for a in ids:
            agent_returns[a].append(float(env_state.last_returns[a][0]))
        team.append(float(_team_return(env_state.last_returns)[0]))
        lengths.append(int(env_state.last_length[0]))
    metrics = EvalMetrics(
        episode_return=torch.tensor(team),
        agent_returns={a: torch.tensor(agent_returns[a]) for a in ids},
        episode_length=torch.tensor(lengths, dtype=torch.int32),
    )
    return train_state, buffer_state, metrics


# ------------------------------------------------------------ Anakin runner


def _act_phase(system: System, tenv, train, env_state, timestep, carry, generator):
    """One vectorised acting step under ``train``'s policy (no dataset write).

    With lane generators the envs step all ``S * N`` copies as one batch
    and the system sees them as ``(S, N)``; the metrics are then per lane.
    Returns ``(env_state, timestep, carry, transition, metrics)``.
    """
    S = lanes.count(generator)
    env_state = replace_reset_keys(env_state, generator)
    obs = lanes.split(timestep.observation, S)
    gs = lanes.split(tenv.global_state(env_state), S)
    actions, new_carry, extras = system.select_actions(
        train, obs, gs, carry, generator, training=True
    )
    new_env_state, new_ts = tenv.step(env_state, lanes.merge(actions, S))
    ts = lanes.split(new_ts, S)
    tr = Transition(
        obs=obs,
        actions=actions,
        rewards=ts.reward,
        discount=ts.discount,
        next_obs=ts.observation,
        state=gs,
        next_state=lanes.split(tenv.global_state(new_env_state), S),
        extras=extras,
        step_type=lanes.split(timestep.step_type, S),
    )
    # a FIRST out of step marks an auto-reset boundary: executor carries
    # restart with the new episode
    done = ts.step_type == StepType.FIRST
    new_carry = reset_carry(
        new_carry, done, initial=system.initial_carry(done.shape, done.device)
    )
    done_f = done.float()
    last_returns = lanes.split(new_env_state.last_returns, S)
    metrics = {
        "reward": torch.stack(list(ts.reward.values())).mean((0, -1)),
        "done_frac": done_f.mean(-1),
        # mean return of the episodes that completed this iteration (0 if none)
        "episode_return": torch.sum(_team_return(last_returns) * done_f, -1)
        / torch.clamp(torch.sum(done_f, -1), min=1.0),
    }
    return new_env_state, new_ts, new_carry, tr, metrics


def _step_phase(system: System, tenv, st: SystemState):
    """One iteration except the trainer update: act, then write the dataset."""
    env_state, ts, carry, tr, metrics = _act_phase(
        system, tenv, st.train, st.env_state, st.timestep, st.carry, st.key
    )
    buffer = system.observe(st.buffer, tr)
    return SystemState(st.train, buffer, env_state, ts, carry, st.key), metrics


def _do_updates(system: System, train, buffer, generator):
    """``updates_per_step`` trainer updates (the gated branch body).

    Returns ``(train, buffer, the last update's metrics)``.
    """
    for _ in range(system.updates_per_step):
        train, buffer, upd = system.update(train, buffer, generator)
    return train, buffer, upd


def _one_iteration(system: System, tenv, st: SystemState):
    """One vectorised step of every env, then ``updates_per_step`` updates if the dataset is ready.

    With seed lanes the gate is one Python ``if`` for all of them: every
    lane's rollout cursor or replay fill moves in step, as the reference's
    hoisted ``lax.cond`` relies on.  Returns ``(state, metrics, the last
    update's metrics or None)``.
    """
    with torch.no_grad():
        st, metrics = _step_phase(system, tenv, st)
    if not system.can_sample(st.buffer):
        return st, metrics, None
    train, buffer, upd = _do_updates(system, st.train, st.buffer, st.key)
    return st._replace(train=train, buffer=buffer), metrics, upd


def seed_generators(seed, num_seeds: int, device) -> tuple:
    """The lane generators of a ``num_seeds`` run: seeds ``seed, ..., seed + num_seeds - 1``.

    ``seed`` may also be the sequence of the lanes' seeds.  Lane ``s``
    draws what the single run with its seed draws.
    """
    seeds = range(seed, seed + num_seeds) if isinstance(seed, int) else list(seed)
    if len(seeds) != num_seeds:
        raise ValueError(f"got {len(seeds)} seeds for num_seeds={num_seeds}")
    return lanes.generators(seeds, device)


def init_system_state(system: System, generator, num_envs: int, train_env=None):
    """A fresh `SystemState` on ``generator``'s device.

    ``generator`` is one `torch.Generator`, or a tuple of lane generators
    (`seed_generators`): then each lane initialises its train state and its
    envs from its own generator, in the order a single run does.
    """
    tenv = train_env if train_env is not None else _training_env(system.env)
    S = lanes.count(generator)
    device = lanes.device(generator)
    if S is None:
        train, batch = system.init_train(generator), (num_envs,)
    else:
        train, batch = lanes.stack([system.init_train(g) for g in generator]), (S, num_envs)
    env_state, ts = tenv.reset(num_envs * (S or 1), device, generator)
    return SystemState(
        train=train,
        buffer=system.init_buffer(batch, device),
        env_state=env_state,
        timestep=ts,
        carry=system.initial_carry(batch, device),
        key=generator,
    )


def _eval_seed(generator):
    """The seed of an interleaved evaluation: one draw from the run's generator(s)."""
    draw = lambda g: int(torch.randint(2**62, (), generator=g, device=g.device))
    if isinstance(generator, tuple):
        return [draw(g) for g in generator]
    return draw(generator)


class _Tap:
    """One run's telemetry tap: a pure observer, off the host's critical path.

    The host counterpart of the reference's ``_tap_body``: after every
    ``log_every``-th iteration ``it`` (0-based), ``log_callback(it,
    updates, metrics)`` gets host copies of the trainer's update count and
    that iteration's metrics, made in one transfer
    (`repro_torch.obs.stream.HostCopy`).  The copy is queued behind the
    iteration's work, and the callback runs at a later iteration, once the
    copy has landed (asked with an event, no wait), or at `drain`, which
    the runner calls before it returns, as the reference drains
    ``jax.debug.callback``'s queue.  So the host never waits on the device
    for the tap, and an iteration that does not log does nothing but ask
    after the copies in flight.  Nothing the callback does can reach the
    run, which only reads its own tensors.
    """

    def __init__(self, log_every: int, log_callback):
        self.on = log_callback is not None and log_every > 0
        self.log_every, self.callback = log_every, log_callback
        self.pending: list = []

    def __call__(self, it: int, updates, metrics) -> None:
        if not self.on:
            return
        if (it + 1) % self.log_every == 0:
            from repro_torch.obs.stream import HostCopy

            self.pending.append((it, HostCopy((updates, metrics))))
        self._deliver(wait=False)

    def drain(self) -> None:
        """Deliver every emission still in flight (waiting for the last copies)."""
        self._deliver(wait=True)

    def _deliver(self, wait: bool) -> None:
        while self.pending and self.pending[0][1].ready(wait):
            it, copy = self.pending.pop(0)
            self.callback(it, *copy.result())


def make_anakin(
    system: System,
    num_iterations: int,
    num_envs: int,
    eval_every: int = 0,
    eval_episodes: int = 32,
    eval_num_envs=None,
    num_seeds=None,
    device=None,
    log_every: int = 0,
    log_callback=None,
):
    """Build the Anakin program as a reusable function of ``seed``.

    ``program(seed) -> (SystemState, metrics)``; ``metrics`` maps
    ``reward`` / ``done_frac`` / ``episode_return`` to ``(num_iterations,)``
    tensors, and each tensor the update reports (``loss``; MADDPG's
    ``critic_loss`` and ``actor_loss``) to its ``(num_updates,)`` values
    over the ready iterations (the last update of each), or an empty
    ``loss`` when none ran.  Nothing waits on the device inside the loop, except
    to draw an evaluation's seed.

    With ``eval_every > 0`` (a divisor of ``num_iterations``) the greedy
    evaluator (`repro_torch.eval.make_evaluator`, ``eval_episodes``
    episodes on ``eval_num_envs`` or ``num_envs`` copies) runs after every
    ``eval_every`` iterations, and the program returns ``(state, metrics,
    evals)``, the `EvalMetrics` leaves stacked to ``(num_iterations //
    eval_every, eval_episodes)``.  Each evaluation's seed is one
    ``torch.randint(2**62)`` draw from the run's generator at that point,
    so ``repro_torch.eval.evaluate(system, train, that_seed, ...)`` from the
    same train state reproduces it.

    With ``num_seeds`` the runs of seeds ``seed, ..., seed + num_seeds -
    1`` (or the sequence ``seed``) go as seed lanes (`seed_generators`):
    metrics, losses and evals gain a leading ``(num_seeds,)`` axis, as do
    the state's train state, carry and env leaves (``(S, N, ...)``); the
    rollout storage stays time-major, ``(T, S, N, ...)``.  Lane ``s`` is
    the single run with its seed, up to the order of sums.

    With ``log_every > 0`` and a ``log_callback`` (typically a
    `repro_torch.obs.MetricTap`), every ``log_every``-th iteration calls
    ``log_callback(iteration, train.steps, metrics)`` with host copies of
    the update count and that iteration's metrics (lane arrays with
    lanes), ``iteration`` 0-based and global across evaluation blocks,
    once the copy has landed and at the latest before the program
    returns.  The tap is a pure observer (`_Tap`): the run is bitwise the
    run without it, and the host never waits on the device for it.
    """
    if num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {num_iterations}")
    device = resolve_device(device)
    tenv = _training_env(system.env)
    eval_fn = None
    if eval_every > 0:
        if num_iterations % eval_every:
            raise ValueError(
                f"num_iterations ({num_iterations}) must be a multiple of "
                f"eval_every ({eval_every})"
            )
        # local import: the evaluator builds on this module's System
        from repro_torch.eval.evaluator import make_evaluator

        eval_fn = make_evaluator(system, eval_episodes, eval_num_envs or num_envs)

    def program(seed):
        if num_seeds is None:
            generator = torch.Generator(device).manual_seed(seed)
        else:
            generator = seed_generators(seed, num_seeds, device)
        S = lanes.count(generator)
        st = init_system_state(system, generator, num_envs, train_env=tenv)
        per_iter, updates, evals = [], [], []
        tap = _Tap(log_every, log_callback)
        for it in range(num_iterations):
            st, metrics, upd = _one_iteration(system, tenv, st)
            per_iter.append(metrics)
            tap(it, st.train.steps, metrics)
            if upd is not None:
                updates.append({k: v for k, v in upd.items() if isinstance(v, torch.Tensor)})
            if eval_fn is not None and (it + 1) % eval_every == 0:
                evals.append(eval_fn(st.train, _eval_seed(generator)))
        tap.drain()
        # per-iteration scalars (or (S,) lane vectors) stacked along a last axis
        out = {k: torch.stack([m[k] for m in per_iter], -1) for k in per_iter[0]}
        lead = () if S is None else (S,)
        if updates:
            out.update({k: torch.stack([u[k] for u in updates], -1) for k in updates[0]})
        else:
            out["loss"] = torch.zeros(*lead, 0, device=device)
        st = st._replace(env_state=lanes.split(st.env_state, S),
                         timestep=lanes.split(st.timestep, S))
        if eval_fn is None:
            return st, out
        return st, out, tree_map(lambda *xs: torch.stack(xs, -2), *evals)

    return program


def train_anakin(
    system: System,
    seed,
    num_iterations: int,
    num_envs: int,
    eval_every: int = 0,
    eval_episodes: int = 32,
    eval_num_envs=None,
    num_seeds=None,
    device=None,
    log_every: int = 0,
    log_callback=None,
):
    """Train for ``num_iterations`` vectorised steps of ``num_envs`` env copies.

    Returns ``(final SystemState, metrics)``, or ``(state, metrics, evals)``
    with ``eval_every > 0``; every leaf gains a leading ``(num_seeds,)``
    axis with ``num_seeds`` (see `make_anakin`).  ``device`` defaults to
    CUDA and raises when none is present.  ``log_every`` /
    ``log_callback`` install the telemetry tap (see `make_anakin`); each
    emission has reached the callback by the time this returns.
    """
    return make_anakin(
        system, num_iterations, num_envs, eval_every=eval_every,
        eval_episodes=eval_episodes, eval_num_envs=eval_num_envs,
        num_seeds=num_seeds, device=device, log_every=log_every, log_callback=log_callback,
    )(seed)


# -------------------------------------------------------- distributed runner


def run_executor(system: System, seed: int, rank: int, num_iterations: int, num_envs: int,
                 eval_episodes: int = 0, eval_num_envs=None, device=None, log_every: int = 0,
                 log_callback=None, warmup: bool = False) -> dict:
    """One rank of the sharded runner, inside a world that has ``"data"`` bound.

    Rank ``rank`` runs anakin from seed ``seed + rank`` (the seed lane
    ``rank`` of a ``num_seeds`` run gets) on its own ``num_envs`` envs and
    dataset; ``system`` must be built with ``distributed_axis="data"``, so
    its updates average their gradients over the ranks.  Returns a dict:
    ``state`` (this rank's final `SystemState`), ``params`` (rank 0's final
    params, broadcast to every rank), ``metrics`` (each metric's mean on
    every rank, and ``wall_s``, each rank's wall time of its training loop
    to the last op, stacked to ``(world,)``) and, with ``eval_episodes > 0``,
    ``eval_return`` (each rank's mean greedy return of ``eval_episodes``
    episodes under its own final params, ``(world,)``; the seed is one
    draw from the rank's generator, as anakin's interleaved evals take).
    ``log_every`` / ``log_callback`` install anakin's telemetry tap on
    this rank's loop.  With ``warmup`` the rank first runs the same
    program once, untapped and untimed, so that ``wall_s`` is a warm loop:
    a fresh process pays its first-use costs (cuBLAS handles, CUDA module
    loads, the allocator's growth, kernel loads) in its first run.
    """
    from repro_torch.distributed import collective

    device = resolve_device(device)
    program = make_anakin(system, num_iterations, num_envs, device=device, log_every=log_every,
                          log_callback=log_callback)
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    if warmup:
        make_anakin(system, num_iterations, num_envs, device=device)(seed + rank)
    sync()
    t0 = time.perf_counter()
    st, metrics = program(seed + rank)
    sync()
    wall = time.perf_counter() - t0
    names = sorted(metrics)
    means = torch.stack([metrics[k].float().mean() for k in names] + [
        torch.tensor(wall, device=device)])
    names.append("wall_s")
    gathered = collective.all_gather(means)  # (world, metrics)
    out = {
        "state": st,
        "params": collective.broadcast(st.train.params),
        "metrics": {k: gathered[:, i] for i, k in enumerate(names)},
    }
    if eval_episodes > 0:
        from repro_torch.eval.evaluator import evaluate

        ev = evaluate(system, st.train, _eval_seed(st.key), num_episodes=eval_episodes,
                      num_envs=eval_num_envs or num_envs, device=device)
        out["eval_return"] = collective.all_gather(ev.episode_return.float().mean())
    return out


def _put(queue, iteration, updates, metrics):
    """A rank's tap: send the emission (host values) to the parent's callback."""
    queue.put((iteration, updates, metrics))


def _executor(rank, world_size, device, system_fn, seed, num_iterations, num_envs,
              eval_episodes, eval_num_envs, log_every, warmup, queue=None):
    """A spawned rank of `make_distributed`'s world: what the program returns."""
    del world_size
    tap = None if queue is None else functools.partial(_put, queue)
    out = run_executor(system_fn(), seed, rank, num_iterations, num_envs, eval_episodes,
                       eval_num_envs, device, log_every=log_every, log_callback=tap,
                       warmup=warmup)
    result = (out["params"], out["metrics"])
    return result + ((out["eval_return"],) if eval_episodes > 0 else ())


def make_distributed(system_fn: Callable[[], System], num_iterations: int,
                     num_envs_per_device: int, num_executors: int, *, backend: str, device,
                     eval_episodes: int = 0, eval_num_envs=None, timeout_s: float = 900.0,
                     log_every: int = 0, log_callback=None, warmup: bool = False):
    """Build the sharded program, a function of ``seed``, on ``torch.distributed``.

    ``system_fn`` builds the `System` with ``distributed_axis="data"``; it
    must pickle (a module-level function or a `functools.partial` of one),
    since every rank is a spawned process that builds its own.  The caller
    chooses ``backend`` and ``device``: ``"gloo"`` on ``"cpu"``, ``"nccl"``
    with ``device="cuda"`` (rank ``r`` on ``cuda:r``; more executors than
    cards raises), or an explicit list of devices, one a rank (gloo with
    CUDA tensors where ranks share a card).  Nothing is switched for the
    caller.

    ``program(seed)`` runs `run_executor` on every rank and returns rank
    0's ``(params, metrics)``, or ``(params, metrics, eval_return)`` with
    ``eval_episodes > 0``: the params are rank 0's final ones (every rank
    returns the same), each metric and the eval return are ``(world,)``,
    one per rank.

    ``log_every`` / ``log_callback`` install anakin's telemetry tap on
    every rank: each rank's emissions travel to this process, where
    ``log_callback(iteration, updates, metrics)`` sees every executor's
    own metrics, as the reference's tap sees each device shard's.  All of
    them have reached the callback by the time the program returns.

    ``warmup`` runs every rank's program once before the timed one (see
    `run_executor`): every call spawns fresh ranks, so no warm call
    survives from one call to the next, and the bench's ``shard_map``
    rung reads its rate from the ranks' warm loops.
    """
    from repro_torch.distributed import collective

    collective.rank_devices(device, num_executors)  # raise before anything is spawned
    tapping = log_every > 0 and log_callback is not None

    def program(seed):
        results = collective.run_world(
            _executor, num_executors, backend, device,
            args=(system_fn, seed, num_iterations, num_envs_per_device, eval_episodes,
                  eval_num_envs, log_every if tapping else 0, warmup),
            timeout_s=timeout_s,
            on_message=(lambda msg: log_callback(*msg)) if tapping else None,
        )
        return results[0]

    return program


def train_distributed(system_fn: Callable[[], System], seed: int, num_iterations: int,
                      num_envs_per_device: int, num_executors: int, *, backend: str, device,
                      eval_episodes: int = 0, eval_num_envs=None, timeout_s: float = 900.0,
                      log_every: int = 0, log_callback=None):
    """Train ``num_executors`` ranks in step: the paper's ``num_executors`` scaling.

    One `make_distributed` run; see there for the arguments and the
    return.  Rank ``r`` starts from seed ``seed + r``, so the ranks'
    initial params differ (as the reference's per-device init makes
    them); every update then applies the same averaged gradients on every
    rank, and the optimizer states stay equal.
    """
    return make_distributed(
        system_fn, num_iterations, num_envs_per_device, num_executors, backend=backend,
        device=device, eval_episodes=eval_episodes, eval_num_envs=eval_num_envs,
        timeout_s=timeout_s, log_every=log_every, log_callback=log_callback,
    )(seed)
