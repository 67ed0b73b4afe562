"""IMPALA-style async actor/learner training (port of `repro.distributed.impala`).

Anakin interleaves acting and learning in lockstep.  `make_async` splits
the two roles as the paper's Launchpad graphs do: ``num_actors`` actor
replicas unroll trajectory chunks under a (possibly stale) snapshot of
the learner's params and push them into a bounded FIFO queue
(`repro_torch.core.buffer.QueueState`); the learner pops chunks and feeds
them row by row through the system's own dataset protocol (``observe``
and the ``can_sample``-gated update) and refreshes the actors' snapshot
every ``param_sync_every`` ticks.

A tick, as in the reference: sync (every ``param_sync_every`` ticks the
snapshot becomes the learner's train state), then the actors' unrolls,
then the pushes (a full queue drops the incoming chunk and counts it),
then the learner's pops (up to ``learner_pops_per_tick``).  It runs as a
Python loop of batched tensor ops, one tick after another, like the
port's anakin; the queue's cursors, the drop count and the staleness are
Python ints, so no tick waits on the device.

The actors are the lanes of one batch (`repro_torch.lanes`): the
snapshot's params are expanded to an ``(A, ...)`` view (no copy) and
every actor steps its own ``num_envs`` envs from its own generator.  The
snapshot is the learner's train state object itself: every update builds
new tensors and writes none in place, so a later update cannot reach the
params the actors act with.  The reference's `_shard_actors` (a logical
``"actors"`` axis, a no-op outside a device mesh) has no counterpart in
one process and is not ported.

Random streams (`_actor_keys`): one actor acts on the run's generator
itself, ``N`` actors on `seed_generators(seed, N)` (the lanes of a
``num_seeds`` run), and the learner draws a chunk's updates from the
generator of the actor that produced it.  At one actor,
``param_sync_every=1`` and an unroll of anakin's cadence (the rollout
length for PPO, 1 for replay) the draws come in anakin's order, so the
run is anakin's, bitwise: the reference's staleness-0 contract.

Staleness bound: a chunk collected under a snapshot is consumed after at
most ``param_sync_every * num_actors * U`` learner updates; every consumed
chunk's staleness (learner updates since its snapshot) is in the
per-tick metrics.  On-policy systems correct stale chunks with V-trace
(``PPOConfig.use_vtrace``); replay systems consume them as they are.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import lanes, resolve_device
from repro_torch.core.buffer import (
    QueueState,
    RolloutState,
    SeqBufferState,
    queue_init,
    queue_pop,
    queue_push,
)
from repro_torch.core.system import (
    System,
    _act_phase,
    _do_updates,
    _Tap,
    _training_env,
    seed_generators,
)
from repro_torch.core.types import TrainState
from repro_torch.tree import tree_leaves, tree_map


class ActorState(NamedTuple):
    """The actor replicas' state: env leaves over ``[A *] num_envs`` copies, carry, generator(s)."""

    env_state: Any
    timestep: Any
    carry: Any
    key: Any  # one generator (one actor) or a tuple, one an actor


class AsyncState(NamedTuple):
    """Everything the async program carries from one tick to the next."""

    train: TrainState  # the learner's live train state
    snapshot: TrainState  # the actors' (possibly stale) train state
    buffer: Any  # the learner's dataset (rollout, replay table, sequence table)
    queue: QueueState  # the trajectory queue between actors and learner
    actors: ActorState
    tick: int  # completed ticks
    dropped: int  # chunks a full queue dropped
    updates: int  # learner updates so far (``train.steps`` minus its start)
    snapshot_updates: int  # learner updates when the snapshot was taken


def default_unroll_len(system: System) -> int:
    """The natural chunk length of a system's dataset regime.

    A rollout system (the PPO family, DIAL) unrolls one rollout a chunk,
    so chunks and updates line up and the staleness-0 run replays
    anakin's cadence; replay and sequence-replay systems take chunks of 8
    steps.  The dataset is built on the ``meta`` device (no memory).
    """
    buffer = system.init_buffer(1, "meta")
    if isinstance(buffer, RolloutState):
        return int(tree_leaves(buffer.storage)[0].shape[0])
    return 8


def _chunk_example(buffer, unroll_len: int, num_envs: int):
    """A zero time-major chunk ``(U, num_envs, ...)`` of the system's per-step `Transition`.

    The rollout and the sequence table's step ring hold ``(T, num_envs,
    ...)`` rows, the flat replay table ``(capacity, ...)`` rows.
    """
    if isinstance(buffer, RolloutState):
        rows, tail = buffer.storage, 2
    elif isinstance(buffer, SeqBufferState):
        rows, tail = buffer.acc, 2
    else:
        rows, tail = buffer.storage, 1
    return tree_map(lambda x: torch.zeros((unroll_len, num_envs, *x.shape[tail:]),
                                          dtype=x.dtype, device=x.device), rows)


def _actor_keys(seed: int, num_actors: int, device):
    """The actors' generators: one actor gets the run's own, ``N`` the lanes of `seed_generators`.

    A single actor's is not one of a split, so it draws what anakin's run
    draws: the staleness-0 pin depends on it.
    """
    if num_actors == 1:
        return torch.Generator(device).manual_seed(seed)
    return seed_generators(seed, num_actors, device)


class AsyncProgram:
    """The async actor/learner program of `make_async`: ``program(seed) -> (state, metrics)``.

    Its phases are methods (`init_state`, then per tick `sync`, `act`,
    `push`, `pop`, `learn`, all four in `tick`), so a profiler can time
    them apart; ``unroll_len`` and ``num_ticks`` are the resolved schedule.
    """

    def __init__(self, system: System, num_envs: int, num_actors: int, param_sync_every: int,
                 unroll_len: int, num_ticks: int, queue_capacity: int, pops: int, device,
                 log_every: int = 0, log_callback=None):
        self.system, self.num_envs, self.num_actors = system, num_envs, num_actors
        self.param_sync_every, self.unroll_len, self.num_ticks = param_sync_every, unroll_len, num_ticks
        self.queue_capacity, self.pops, self.device = queue_capacity, pops, device
        self.log_every, self.log_callback = log_every, log_callback
        self.tenv = _training_env(system.env)

    def init_state(self, seed: int) -> AsyncState:
        """A fresh state: actor ``a`` initialises as lane ``a`` of a ``num_seeds`` run would.

        The learner takes actor 0's train state; with one actor the draws
        are anakin's init's, in its order.
        """
        system, gens = self.system, _actor_keys(seed, self.num_actors, self.device)
        A = lanes.count(gens)
        train = system.init_train(gens) if A is None else [system.init_train(g) for g in gens][0]
        env_state, ts = self.tenv.reset(self.num_envs * (A or 1), self.device, gens)
        carry = system.initial_carry((self.num_envs,) if A is None else (A, self.num_envs),
                                     self.device)
        buffer = system.init_buffer(self.num_envs, self.device)
        example = {"chunk": _chunk_example(buffer, self.unroll_len, self.num_envs),
                   "snapshot_updates": 0, "actor": 0}
        return AsyncState(
            train=train, snapshot=train, buffer=buffer,
            queue=queue_init(example, self.queue_capacity),
            actors=ActorState(env_state, ts, carry, gens),
            tick=0, dropped=0, updates=0, snapshot_updates=0,
        )

    def sync(self, state: AsyncState) -> AsyncState:
        """Every ``param_sync_every`` ticks the snapshot becomes the learner's train state."""
        if state.tick % self.param_sync_every:
            return state
        return state._replace(snapshot=state.train, snapshot_updates=state.updates)

    def act(self, state: AsyncState):
        """Every actor unrolls ``unroll_len`` steps under the snapshot.

        Returns ``(state, chunks, metrics)``: chunk leaves ``(U, [A,] N,
        ...)``, and the acting metrics averaged over the unroll and the
        actors (device scalars).
        """
        act = state.actors
        A = lanes.count(act.key)
        snap = state.snapshot
        if A is not None:  # one (A, ...) view of the shared snapshot, a lane an actor
            expand = lambda x: x.expand(A, *x.shape) if isinstance(x, torch.Tensor) else x
            snap = snap._replace(params=tree_map(expand, snap.params),
                                 target_params=tree_map(expand, snap.target_params))
        env_state, ts, carry = act.env_state, act.timestep, act.carry
        trs, ms = [], []
        with torch.no_grad():
            for _ in range(self.unroll_len):
                env_state, ts, carry, tr, m = _act_phase(self.system, self.tenv, snap, env_state,
                                                         ts, carry, act.key)
                trs.append(tr)
                ms.append(m)
        chunks = tree_map(lambda *xs: torch.stack(xs), *trs)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return state._replace(actors=ActorState(env_state, ts, carry, act.key)), chunks, metrics

    def push(self, state: AsyncState, chunks) -> AsyncState:
        """Push each actor's chunk, in actor order; a full queue drops it and counts the drop."""
        A = lanes.count(state.actors.key)
        queue, dropped = state.queue, state.dropped
        for a in range(A or 1):
            chunk = chunks if A is None else tree_map(lambda x: x[:, a], chunks)
            queue, ok = queue_push(queue, {"chunk": chunk,
                                           "snapshot_updates": state.snapshot_updates,
                                           "actor": a})
            dropped += not ok
        return state._replace(queue=queue, dropped=dropped)

    def pop(self, state: AsyncState):
        """Pop up to ``learner_pops_per_tick`` chunks (views of their slots): ``(state, items)``."""
        queue, items = state.queue, []
        for _ in range(min(self.pops, queue.size)):
            queue, item = queue_pop(queue)
            items.append(item)
        return state._replace(queue=queue), items

    def learn(self, state: AsyncState, items):
        """Consume the popped chunks in order: ``(state, mean staleness)``.

        Each chunk's rows go through ``observe`` and the gated update one
        by one, anakin's per-iteration cadence, with the updates drawn
        from the generator of the actor that produced the chunk.  A
        chunk's staleness is the learner updates since its snapshot, read
        before it is consumed.
        """
        system, gens = self.system, state.actors.key
        train, buffer, updates, stale = state.train, state.buffer, state.updates, 0
        for item in items:
            stale += updates - item["snapshot_updates"]
            generator = gens if lanes.count(gens) is None else gens[item["actor"]]
            for u in range(self.unroll_len):
                with torch.no_grad():
                    buffer = system.observe(buffer, tree_map(lambda x: x[u], item["chunk"]))
                if system.can_sample(buffer):
                    train, buffer, _ = _do_updates(system, train, buffer, generator)
                    updates += system.updates_per_step
        staleness = stale / len(items) if items else 0.0
        return state._replace(train=train, buffer=buffer, updates=updates), staleness

    def tick(self, state: AsyncState):
        """One learner tick: sync, actor unrolls, pushes, learner pops: ``(state, metrics)``."""
        state = self.sync(state)
        state, chunks, metrics = self.act(state)
        state = self.push(state, chunks)
        depth = state.queue.size
        state, items = self.pop(state)
        state, staleness = self.learn(state, items)
        state = state._replace(tick=state.tick + 1)
        return state, {**metrics, "queue_depth": depth, "staleness": staleness,
                       "consumed": len(items), "dropped": state.dropped}

    def __call__(self, seed: int):
        """Run every tick from ``seed``: ``(AsyncState, metrics)``.

        ``metrics`` maps each acting metric (``reward``, ``done_frac``,
        ``episode_return``: the mean over a tick's unroll and actors) and
        ``queue_depth`` (after the pushes), ``staleness`` (the mean of the
        chunks consumed that tick), ``consumed`` and the cumulative
        ``dropped`` to a float32 ``(num_ticks,)`` tensor on the run's device.
        The telemetry tap (`repro_torch.core.system._Tap`) emits every
        ``log_every`` ticks the learner's update count and the tick's
        metrics, all of them before this returns.
        """
        state = self.init_state(seed)
        per_tick = []
        tap = _Tap(self.log_every, self.log_callback)
        for t in range(self.num_ticks):
            state, m = self.tick(state)
            per_tick.append(m)
            tap(t, state.train.steps, m)
        tap.drain()
        metrics = {}
        for k in per_tick[0]:
            vals = [m[k] for m in per_tick]
            metrics[k] = (torch.stack(vals) if isinstance(vals[0], torch.Tensor)
                          else torch.tensor(vals, dtype=torch.float32, device=self.device))
        return state, metrics


def make_async(system: System, num_iterations: int, num_envs: int, num_actors: int,
               param_sync_every: int = 1, unroll_len: Optional[int] = None,
               queue_capacity: Optional[int] = None,
               learner_pops_per_tick: Optional[int] = None, device=None, log_every: int = 0,
               log_callback=None) -> AsyncProgram:
    """Build the async actor/learner program, a function of ``seed``.

    ``num_iterations`` counts env steps of each env of each actor
    (anakin's unit), so ``make_async(system, N, E, 1)`` does the env-step
    work of ``make_anakin(system, N, E)``; it must divide into
    ``unroll_len``-step ticks (default `default_unroll_len`).  The queue
    holds ``queue_capacity`` chunks (default ``2 * num_actors``) and the
    learner pops up to ``learner_pops_per_tick`` a tick (default
    ``num_actors``: it keeps up exactly).  ``device`` defaults to CUDA and
    raises when there is none.  ``log_every`` / ``log_callback`` install
    the telemetry tap, which counts learner ticks (the reference's scan
    unit), as anakin's counts iterations.
    """
    if num_actors < 1:
        raise ValueError(f"num_actors must be >= 1, got {num_actors}")
    if param_sync_every < 1:
        raise ValueError(f"param_sync_every must be >= 1, got {param_sync_every}")
    unroll = unroll_len or default_unroll_len(system)
    if num_iterations % unroll:
        raise ValueError(
            f"num_iterations ({num_iterations}) must be a multiple of the "
            f"unroll length ({unroll})"
        )
    return AsyncProgram(system, num_envs, num_actors, param_sync_every, unroll,
                        num_iterations // unroll, queue_capacity or 2 * num_actors,
                        learner_pops_per_tick or num_actors, resolve_device(device),
                        log_every=log_every, log_callback=log_callback)


def train_async(system: System, seed: int, num_iterations: int, num_envs: int,
                num_actors: int, param_sync_every: int = 1, unroll_len: Optional[int] = None,
                queue_capacity: Optional[int] = None,
                learner_pops_per_tick: Optional[int] = None, device=None, log_every: int = 0,
                log_callback=None):
    """One `make_async` run: ``(AsyncState, metrics)``; ``state.train`` is the learner's."""
    return make_async(system, num_iterations, num_envs, num_actors,
                      param_sync_every=param_sync_every, unroll_len=unroll_len,
                      queue_capacity=queue_capacity, learner_pops_per_tick=learner_pops_per_tick,
                      device=device, log_every=log_every, log_callback=log_callback)(seed)
