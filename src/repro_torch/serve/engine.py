"""Slot-based decision-serving engine for trained MARL policies (port of `repro.serve.engine`).

A fixed pool of ``max_slots`` episode slots shares one batched env and
carry state; per-user episode requests are admitted into free slots, and
one tick advances every slot at once: the policy step, the batched env
step and the carry bookkeeping, on the pool's device, with shapes that
never change.

Per-slot memory is the `repro_torch.core.types.Carry` of the memory-core
protocol: one row a slot, zeroed on admission and at episode boundaries
through its one masking rule (`repro_torch.nn.recurrent.reset_carry`).
A feed-forward policy's carry is empty and all of this is free.  The
served tick calls the memory core's ``step``, never its ``unroll``, so no
hand kernel runs while serving.

Action modes are the executor's two faces:

* ``greedy``: ``select_actions(..., training=False)``, the evaluator's
  argmax path, so served decisions equal offline evaluation's;
* ``sample``: ``training=True``, the behaviour policy (categorical or
  eps-greedy draws from the engine's own generator).

A tick copies to the host once: the live decisions, each slot's running
per-agent and team returns (float32, accumulated on the device in the
evaluator's order) and the episode-end flags, packed into one transfer
(`repro_torch.obs.stream.host_values`).  A request's reset draws from a
`torch.Generator` built from its own seed, on the pool's device; a caller
may pass a ready batch-of-one reset instead (``ServeRequest.reset``).

The requests a tick admits reset in one batched ``env.reset``, each as a
seed lane with its own generator (`repro_torch.lanes`), so each draws
what a reset of its own would; one ``index_copy`` a leaf puts them into
their slots.  The reference resets one env an admission, which at a
few hundred slots makes an admission wave cost more than the ticks.  As
in the reference, free slots still burn the policy and env step (their
outputs are dropped).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.envs.api import StepType
from repro_torch.eval.evaluator import _as_train_state
from repro_torch.nn.recurrent import reset_carry
from repro_torch.obs.stream import host_values
from repro_torch.tree import tree_map


@dataclasses.dataclass
class ServeRequest:
    """One user's episode: a reset seed in, decisions and a return out.

    ``seed`` builds the generator the episode's ``env.reset`` draws from;
    ``reset``, when given, is that reset already made (an ``(env_state,
    timestep)`` batch of one), and ``seed`` is then unused.
    """

    uid: int
    seed: int = 0
    arrival_tick: int = 0  # when the traffic trace makes this request arrive
    reset: Any = None
    # filled by the engine
    slot: Optional[int] = None
    episode_return: float = 0.0  # team return (mean over agents)
    agent_returns: Dict[str, float] = dataclasses.field(default_factory=dict)
    length: int = 0
    done: bool = False
    actions: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


class DecisionEngine:
    """Serve per-user episodes of ``system``'s env from a fixed slot pool.

        env, system, train = load_policy("results/port/ckpt/rec_ippo")
        engine = DecisionEngine(system, train, max_slots=8)
        engine.submit(ServeRequest(uid=0, seed=7))
        while not engine.idle():
            decisions = engine.tick()   # {uid: {agent: action}} this tick

    ``tick()`` admits queued requests into free slots (lowest slot first,
    FIFO queue), runs the policy and env step over the whole pool, returns
    the live slots' joint actions and retires the episodes that reached
    LAST (the slot is freed, its carry already zeroed inside the tick).
    Each tick's wall time, from before admission to the decisions on the
    host, and its live-slot count go to ``tick_log``.

    The pool lives on ``device`` (default CUDA, raising without it); the
    train state is moved there.  ``seed`` seeds the pool's placeholder
    episodes and, in ``sample`` mode, the action draws.
    """

    def __init__(self, system, train, max_slots: int = 8, mode: str = "greedy", seed: int = 0,
                 record_actions: bool = False, warmup: bool = True, device=None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if mode not in ("greedy", "sample"):
            raise ValueError(f"mode must be 'greedy' or 'sample', got {mode!r}")
        self.device = resolve_device(device)
        self.system = system
        self.env = system.env  # the raw env: LAST retires the slot, no auto-reset
        to_dev = lambda x: x.to(self.device) if isinstance(x, torch.Tensor) else x
        self.train = tree_map(to_dev, _as_train_state(train))
        self.max_slots = max_slots
        self.mode = mode
        self.record_actions = record_actions
        self._ids = list(system.spec.agent_ids)
        self._generator = torch.Generator(self.device).manual_seed(seed)

        self.queue: Deque[ServeRequest] = deque()
        self.slots: List[Optional[ServeRequest]] = [None] * max_slots
        self.finished: List[ServeRequest] = []
        self.tick_log: List[Dict[str, float]] = []  # wall seconds + live count

        # the pool: batched env state / timestep / carry / running returns, a
        # row a slot (free rows hold placeholder episodes, stepped and ignored)
        self._env_state, self._ts = self.env.reset(max_slots, self.device, self._generator)
        self._initial_carry = system.initial_carry((max_slots,), self.device)
        self._carry = self._initial_carry
        self._returns = {a: torch.zeros(max_slots, device=self.device) for a in self._ids}
        self._live = np.zeros(max_slots, dtype=bool)
        if warmup:
            self.warmup()

    # ------------------------------------------------------------ device work

    def _admit_fn(self, env_state, ts, carry, returns, reset, slots):
        """Put a reset of ``len(slots)`` envs into pool rows ``slots``; zero their carry and returns.

        The carry goes through `reset_carry` with the slots' mask, as the
        training runners reset at FIRST boundaries.  Every write makes new
        tensors: the pool's old ones are left as they were.
        """
        new_state, new_ts = reset
        rows = torch.tensor(slots, dtype=torch.int64)
        if self.device.type == "cuda":
            # from pinned memory the copy needs no wait; PyTorch's pinned
            # allocator keeps the block until the copy has run
            rows = rows.pin_memory().to(self.device, non_blocking=True)
        merge = lambda pool, new: (pool.index_copy(0, rows, new.to(pool.dtype))
                                   if isinstance(pool, torch.Tensor) else pool)
        mask = torch.zeros(self.max_slots, dtype=torch.bool, device=self.device)
        mask = mask.index_fill(0, rows, True)
        carry = reset_carry(carry, mask, initial=self._initial_carry)
        returns = {a: torch.where(mask, 0.0, r) for a, r in returns.items()}
        return tree_map(merge, env_state, new_state), tree_map(merge, ts, new_ts), carry, returns

    def _tick_fn(self, env_state, ts, carry, returns, generator):
        """One decision tick over the whole pool.

        The policy step (greedy or sampled), the batched env step, the
        returns (float32, ``returns + reward`` as the evaluator adds them)
        and the episode-boundary carry reset: rows whose step reached LAST
        restart from zero memory, so a recycled slot never sees the
        previous user's state.  Returns the new pool and the tick's
        ``(actions, returns, team return, ended)`` on the device.
        """
        with torch.no_grad():
            gs = self.env.global_state(env_state)
            actions, carry, _ = self.system.select_actions(
                self.train, ts.observation, gs, carry, generator,
                training=(self.mode == "sample"),
            )
            new_env_state, new_ts = self.env.step(env_state, actions)
            ended = new_ts.step_type == StepType.LAST
            carry = reset_carry(carry, ended, initial=self._initial_carry)
            returns = {a: returns[a] + new_ts.reward[a] for a in self._ids}
            team = torch.mean(torch.stack([returns[a] for a in self._ids]), dim=0)
        return (new_env_state, new_ts, carry, returns), (actions, returns, team, ended)

    def _resets(self, reqs: List[ServeRequest]):
        """The admitted requests' resets as one batch, in ``reqs``' order.

        Seeded requests reset together, a lane each (`lanes` draws each
        lane's rows from its own generator: what ``env.reset(1, device,
        its generator)`` draws); a request that brings its own reset has
        it joined in its place.
        """
        gens = tuple(torch.Generator(self.device).manual_seed(r.seed)
                     for r in reqs if r.reset is None)
        drawn = self.env.reset(len(gens), self.device, gens) if gens else None
        if all(r.reset is None for r in reqs):
            return drawn
        rows, i = [], 0
        for r in reqs:
            if r.reset is None:
                rows.append(tree_map(lambda x, i=i: x[i:i + 1] if isinstance(x, torch.Tensor)
                                     else x, drawn))
                i += 1
            else:
                rows.append(r.reset)
        return tree_map(lambda *xs: torch.cat(xs) if isinstance(xs[0], torch.Tensor) else xs[0],
                        *rows)

    def warmup(self) -> None:
        """Run an admission and a tick on the pool and drop the results.

        Both are functions of the pool, which they leave as it was, so
        this changes nothing; it takes the first-use costs (cuBLAS handles,
        allocations) off the first served tick.  Sample mode draws from a
        generator of its own here.
        """
        pool = self._admit_fn(self._env_state, self._ts, self._carry, self._returns,
                              self._resets([ServeRequest(uid=-1)]), [0])
        _, out = self._tick_fn(*pool, torch.Generator(self.device).manual_seed(1))
        host_values(out)

    # ------------------------------------------------------------- admission

    def submit(self, req: ServeRequest) -> None:
        """Queue one episode request (FIFO; admitted on the next tick)."""
        self.queue.append(req)

    def _admit(self) -> None:
        """Fill free slots from the queue (lowest slot first, FIFO order), in one batch."""
        admitted = []
        for slot in range(self.max_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req.slot = slot
            self.slots[slot] = req
            self._live[slot] = True
            admitted.append(req)
        if admitted:
            self._env_state, self._ts, self._carry, self._returns = self._admit_fn(
                self._env_state, self._ts, self._carry, self._returns, self._resets(admitted),
                [r.slot for r in admitted])

    # ------------------------------------------------------------------ tick

    def idle(self) -> bool:
        """True when no request is queued or being served."""
        return not self.queue and not self._live.any()

    def tick(self) -> Dict[int, Dict[str, Any]]:
        """Admit, decide one joint action for every live slot, retire LASTs.

        Returns ``{uid: {agent_id: action}}`` for the slots that were live
        this tick: the decisions a server ships back to its users.
        """
        t0 = time.perf_counter()
        self._admit()
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return {}
        pool, out = self._tick_fn(self._env_state, self._ts, self._carry, self._returns,
                                  self._generator)
        self._env_state, self._ts, self._carry, self._returns = pool
        actions, returns, team, ended = host_values(out)  # the tick's one copy to the host

        emitted: Dict[int, Dict[str, Any]] = {}
        for i in live:
            req = self.slots[i]
            decision = {a: actions[a][i] for a in self._ids}
            emitted[req.uid] = decision
            if self.record_actions:
                req.actions.append(decision)
            req.length += 1
            if ended[i]:
                req.agent_returns = {a: np.float32(returns[a][i]) for a in self._ids}
                req.episode_return = float(team[i])
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
                self._live[i] = False
        self.tick_log.append({"seconds": time.perf_counter() - t0, "live": len(live)})
        return emitted

    def run_until_drained(self, max_ticks: int = 100_000) -> List[ServeRequest]:
        """Tick until the queue and every slot are empty; return the finished requests."""
        for _ in range(max_ticks):
            if self.idle():
                break
            self.tick()
        return self.finished

    # --------------------------------------------------------- introspection

    @property
    def carry(self):
        """The pool's executor memory (a row a slot), for tests."""
        return self._carry

    @property
    def num_live(self) -> int:
        """How many slots hold a running episode."""
        return int(self._live.sum())
