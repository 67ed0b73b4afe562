"""The port's switch_game, speaker_listener, smax_lite and robot_warehouse against the JAX package.

Whole episodes run through ``EpisodeStats(AutoReset(env))`` in both
packages, across auto-reset boundaries, on the same numpy-drawn actions.
The port's resets are the reference's, converted across
(`repro_torch.convert.reset_from_jax`): the first one and every
auto-reset, which the JAX stack draws from its `AutoReset` key each step.
The draws inside ``step`` are injected too: switch_game's next prisoner
(`switch_game._next_prisoner`) and robot_warehouse's re-request noise
(`robot_warehouse._request_noise`), computed from the JAX state's key as
the reference's step computes them.  Integer and boolean state must match
exactly, floats at 1e-6.

Beside them, the reference's own env unit tests, ported:
tests/test_envs.py's switch-game reward logic and tests/test_gridworlds.py's
robot-warehouse load, delivery (with the re-request held against the
reference's draw), blocking and horizon tests; the specs against the
reference's; and seed lanes that draw inside ``step`` as each lane alone.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.envs import make_env as jax_make_env  # noqa: E402
from repro.envs.robot_warehouse import RobotWarehouse as JaxRware  # noqa: E402
from repro.envs.robot_warehouse import RwareState as JaxRwareState  # noqa: E402
from repro.envs.smax_lite import SmaxLite as JaxSmax  # noqa: E402
from repro.envs.speaker_listener import SpeakerListener as JaxSL  # noqa: E402
from repro.envs.switch_game import SwitchGame as JaxSwitch  # noqa: E402
from repro.envs.wrappers import AgentIdObs as JaxAgentIdObs  # noqa: E402
from repro.envs.wrappers import AutoReset as JaxAutoReset  # noqa: E402
from repro.envs.wrappers import ConcatObsState as JaxConcatObsState  # noqa: E402
from repro.envs.wrappers import EpisodeStats as JaxEpisodeStats  # noqa: E402
from repro_torch import lanes  # noqa: E402
from repro_torch.convert import reset_from_jax  # noqa: E402
from repro_torch.envs import (  # noqa: E402
    REGISTRY,
    AgentIdObs,
    AutoReset,
    ConcatObsState,
    EpisodeStats,
    RobotWarehouse,
    SmaxLite,
    SpeakerListener,
    StepType,
    SwitchGame,
    make_env,
)
from repro_torch.envs import robot_warehouse as trware  # noqa: E402
from repro_torch.envs import switch_game as tswitch  # noqa: E402
from repro_torch.envs.robot_warehouse import RwareState  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


FLOAT_TOL = 1e-6
N = 6


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLOAT_TOL, rtol=FLOAT_TOL)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _check_state(t, j):
    """A raw env state, field by field: floats at 1e-6, the rest exactly."""
    for name in t._fields:
        if name == "key":
            continue
        got, want = getattr(t, name), getattr(j, name)
        (_close if got.dtype == torch.float32 else _eq)(got, want)
        assert got.dtype == {np.dtype("float32"): torch.float32, np.dtype("int32"): torch.int32,
                             np.dtype("bool"): torch.bool}[np.asarray(want).dtype]


def _injected(cls):
    """``cls`` whose resets are queued JAX resets, converted (the `AutoReset` draws)."""

    @dataclasses.dataclass(frozen=True)
    class Injected(cls):
        def __post_init__(self):
            if hasattr(cls, "__post_init__"):
                super().__post_init__()
            object.__setattr__(self, "queue", [])

        def reset(self, num_envs, device, generator=None):
            state, ts = reset_from_jax(self.queue.pop(0), device, generator)
            assert ts.step_type.shape == (num_envs,)
            return state, ts

    return Injected


CASES = {
    # name: (reference raw env, port raw class, kwargs, gridworld stack, steps)
    "switch_game": (JaxSwitch, SwitchGame, {}, False, 24),
    "speaker_listener": (JaxSL, SpeakerListener, dict(horizon=7), False, 18),
    "smax_lite": (JaxSmax, SmaxLite, dict(horizon=30), False, 40),
    "robot_warehouse": (JaxRware, RobotWarehouse,
                        dict(grid_size=6, num_shelves=4, horizon=9), True, 24),
}


@functools.partial(jax.jit, static_argnums=1)
def _switch_draws_jax(keys, n):
    return jax.vmap(lambda k: jax.random.randint(jax.random.split(k)[1], (), 0, n))(keys)


def _switch_draws(jraw):
    """The next prisoner the reference's step draws (switch_game.py:102-103)."""
    return torch.from_numpy(np.array(_switch_draws_jax(jraw.key, jraw.in_room.shape[-1])))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _rware_noise_jax(keys, num_agents, num_shelves):
    def one(key):
        _, k = jax.random.split(key)
        out = []
        for _ in range(num_agents):
            k, kk = jax.random.split(k)
            out.append(jax.random.gumbel(kk, (num_shelves,), jnp.float32))
        return jnp.stack(out)

    return jax.vmap(one)(keys)


def _rware_noise(jraw, num_agents, num_shelves):
    """The Gumbel noise of the reference's re-request scan (robot_warehouse.py:194-205)."""
    return torch.from_numpy(np.array(_rware_noise_jax(jraw.key, num_agents, num_shelves)))


@pytest.mark.parametrize("name", list(CASES))
def test_episodes_through_autoreset_match(name, monkeypatch):
    jcls, tcls, kw, grid, steps = CASES[name]
    jraw = jcls(**kw)
    traw = _injected(tcls)(**kw)
    jinner = JaxConcatObsState(JaxAgentIdObs(jraw)) if grid else jraw
    tinner = ConcatObsState(AgentIdObs(traw)) if grid else traw
    jenv, tenv = JaxEpisodeStats(JaxAutoReset(jinner)), EpisodeStats(AutoReset(tinner))
    keys = jax.random.split(jax.random.key(7), N)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    jreset = jax.jit(jax.vmap(jraw.reset))
    traw.queue.append(jreset(keys))
    gen = torch.Generator().manual_seed(0)
    tstate, tts = tenv.reset(N, "cpu", gen)
    jstep = jax.jit(jax.vmap(jenv.step))
    jgs = jax.jit(jax.vmap(jenv.global_state))
    rng = np.random.default_rng(1)
    spec = tenv.spec()
    ids = spec.agent_ids
    boundaries = 0
    for _ in range(steps):
        for a in ids:
            _close(tts.observation[a], jts.observation[a])
        _close(tenv.global_state(tstate), jgs(jstate))
        # the draws of this step: the auto-reset, and those inside the raw step
        jraw_state = jstate.inner.inner
        traw.queue.append(jreset(jstate.inner.key))
        if name == "switch_game":
            draw = _switch_draws(jraw_state)
            monkeypatch.setattr(tswitch, "_next_prisoner", lambda g, n, A, d: draw)
        if name == "robot_warehouse":
            noise = _rware_noise(jraw_state, jraw.num_agents, jraw.num_shelves)
            monkeypatch.setattr(trware, "_request_noise", lambda g, n, A, S, d: noise)
        acts = {a: rng.integers(0, spec.actions[a].num_values, N).astype(np.int32) for a in ids}
        jstate, jts = jstep(jstate, acts)
        tstate, tts = tenv.step(tstate, {a: torch.from_numpy(x) for a, x in acts.items()})
        assert not traw.queue
        _eq(tts.step_type, jts.step_type)
        _eq(tts.discount, jts.discount)
        for a in ids:
            _close(tts.reward[a], jts.reward[a])
            _close(tstate.returns[a], jstate.returns[a])
            _close(tstate.last_returns[a], jstate.last_returns[a])
        _eq(tstate.length, jstate.length)
        _eq(tstate.last_length, jstate.last_length)
        _check_state(tstate.inner.inner, jstate.inner.inner)
        assert tstate.inner.key is gen
        if name in ("switch_game", "robot_warehouse"):  # the raw state keeps its generator
            assert tstate.inner.inner.key is gen
        boundaries += int((tts.step_type == StepType.FIRST).sum())
    assert boundaries >= N  # every env crossed an auto-reset boundary


def test_specs_and_registry_match_the_reference():
    for name in REGISTRY:
        tspec, jspec = make_env(name).spec(), jax_make_env(name).spec()
        assert tspec.agent_ids == jspec.agent_ids
        assert tspec.state.shape == jspec.state.shape
        for a in tspec.agent_ids:
            assert tspec.observations[a].shape == jspec.observations[a].shape
            assert (getattr(tspec.actions[a], "num_values", None)
                    == getattr(jspec.actions[a], "num_values", None))
        assert make_env(name).horizon == jax_make_env(name).horizon
    assert sorted(REGISTRY) == sorted(
        ["lbf", "matrix_game", "robot_warehouse", "smax_lite", "speaker_listener", "spread",
         "switch_game"])


@pytest.mark.parametrize("n_agents", [2, 3, 4, 5])
def test_switch_game_reward_logic(n_agents):
    """Reward is paid only on a Tell, +1 iff every agent has been in the room (tests/test_envs.py:131)."""
    env = SwitchGame(num_agents=n_agents)
    g = torch.Generator().manual_seed(n_agents)
    state, ts = env.reset(64, "cpu", g)
    assert (ts.step_type == StepType.FIRST).all()
    # walk some envs until everyone has visited, then everyone says Tell
    quiet = {a: torch.zeros(64, dtype=torch.int32) for a in env.agent_ids}
    for _ in range(int(n_agents > 2)):
        state, _ = env.step(state, quiet)
    all_visited = state.has_been.all(-1)
    tell = {a: torch.ones(64, dtype=torch.int32) for a in env.agent_ids}
    state, ts = env.step(state, tell)
    r = ts.reward["agent_0"]
    _eq(r, torch.where(all_visited, 1.0, -1.0).numpy())
    assert (ts.step_type == StepType.LAST).all()
    for a in env.agent_ids:  # the reward is shared
        _eq(ts.reward[a], r.numpy())
    # None (0) by everyone pays nothing and runs to the horizon
    state, ts = env.reset(64, "cpu", g)
    for t in range(env.horizon):
        state, ts = env.step(state, quiet)
        assert (ts.reward["agent_0"] == 0).all()
        want = StepType.LAST if t == env.horizon - 1 else StepType.MID
        assert (ts.step_type == want).all()


# ----------------------------------------------------------------- rware


def _rware():
    return RobotWarehouse(num_agents=2, grid_size=8, num_shelves=4, num_requests=2)


def _rware_state(pos, carrying, requested, generator=None):
    return RwareState(
        t=torch.zeros(1, dtype=torch.int32),
        pos=torch.tensor([pos], dtype=torch.int32),
        carrying=torch.tensor([carrying], dtype=torch.int32),
        requested=torch.tensor([requested]),
        key=generator,
    )


def _acts(env, values):
    return {a: torch.tensor([v], dtype=torch.int32) for a, v in zip(env.agent_ids, values)}


def test_rware_load_picks_requested_shelf():
    env = _rware()
    shelf0 = tuple(env._shelf_cells()[0])
    state = _rware_state([shelf0, (0, 0)], [-1, -1], [True, True, False, False],
                         torch.Generator().manual_seed(0))
    state, ts = env.step(state, _acts(env, [5, 0]))  # agent_0 loads shelf 0
    assert state.carrying.tolist() == [[0, -1]]
    assert float(ts.reward["agent_0"]) == 0.0  # pickup alone pays nothing


def test_rware_delivery_pays_team_and_resamples_request(monkeypatch):
    env, jenv = _rware(), JaxRware(num_agents=2, grid_size=8, num_shelves=4, num_requests=2)
    goal = env._goal_cell()
    above = (goal[0] - 1, goal[1])
    pos, carrying, requested = [above, (0, 0)], [1, -1], [True, True, False, False]
    jstate = JaxRwareState(t=jnp.zeros((), jnp.int32), pos=jnp.asarray(pos, jnp.int32),
                           carrying=jnp.asarray(carrying, jnp.int32),
                           requested=jnp.asarray(requested), key=jax.random.key(3))
    noise = _rware_noise(jax.tree_util.tree_map(lambda x: x[None], jstate), 2, 4)
    monkeypatch.setattr(trware, "_request_noise", lambda g, n, A, S, d: noise)
    state, ts = env.step(_rware_state(pos, carrying, requested), _acts(env, [2, 0]))
    jstate, jts = jenv.step(jstate, {a: jnp.asarray(v, jnp.int32)
                                     for a, v in zip(env.agent_ids, [2, 0])})
    assert tuple(state.pos[0, 0].tolist()) == goal  # moved down onto the goal
    # a sparse shared +1; the delivered shelf unloaded; a fresh request
    assert float(ts.reward["agent_0"]) == float(ts.reward["agent_1"]) == 1.0
    assert state.carrying.tolist() == [[-1, -1]]
    assert int(state.requested.sum()) == env.num_requests
    # the re-request is the reference's draw on the reference's noise
    _eq(state.requested[0], jstate.requested)
    _eq(state.pos[0], jstate.pos)
    for a in env.agent_ids:
        _close(ts.observation[a][0], jts.observation[a])


def test_rware_loaded_robot_blocked_by_occupied_rack():
    env = _rware()
    shelf0 = tuple(env._shelf_cells()[0])
    left = (shelf0[0], shelf0[1] - 1)
    g = torch.Generator().manual_seed(0)
    # agent_0 carries shelf 1 and tries to move right under shelf 0
    state, _ = env.step(_rware_state([left, (0, 0)], [1, -1], [True, True, False, False], g),
                        _acts(env, [4, 0]))
    assert tuple(state.pos[0, 0].tolist()) == left  # blocked
    # unloaded robots pass under racks freely
    state, _ = env.step(_rware_state([left, (0, 0)], [-1, -1], [True, True, False, False], g),
                        _acts(env, [4, 0]))
    assert tuple(state.pos[0, 0].tolist()) == shelf0


def test_rware_episode_ends_on_horizon_only():
    env = RobotWarehouse(num_agents=2, grid_size=6, num_shelves=4, horizon=5)
    state, ts = env.reset(3, "cpu", torch.Generator().manual_seed(0))
    # distinct spawn cells off the racks and the goal, num_requests requests
    cells = set(map(tuple, env._free_cells()))
    for e in range(3):
        assert {tuple(p) for p in state.pos[e].tolist()} <= cells
        assert len({tuple(p) for p in state.pos[e].tolist()}) == 2
    assert (state.requested.sum(-1) == env.num_requests).all()
    for t in range(1, 6):
        state, ts = env.step(state, {a: torch.zeros(3, dtype=torch.int32)
                                     for a in env.agent_ids})
        want = StepType.LAST if t == 5 else StepType.MID
        assert (ts.step_type == want).all()


@pytest.mark.parametrize("name", ["switch_game", "robot_warehouse", "smax_lite",
                                  "speaker_listener"])
def test_lanes_draw_as_each_lane_alone(name):
    """Seed lanes, with the draws inside ``step``: lane ``s`` is the run with seed ``s``."""
    env = AutoReset(make_env(name, **({"horizon": 6} if name != "switch_game" else {})))
    spec = env.spec()
    rng = np.random.default_rng(0)
    acts = [{a: rng.integers(0, spec.actions[a].num_values, 2 * N).astype(np.int32)
             for a in spec.agent_ids} for _ in range(14)]
    state, _ = env.reset(2 * N, "cpu", lanes.generators([5, 7], "cpu"))
    alone = [env.reset(N, "cpu", torch.Generator().manual_seed(s))[0] for s in (5, 7)]
    for act in acts:
        state, _ = env.step(state, {a: torch.from_numpy(x) for a, x in act.items()})
        for i in range(2):
            part = {a: torch.from_numpy(x[i * N:(i + 1) * N]) for a, x in act.items()}
            alone[i], _ = env.step(alone[i], part)
            for x, y in zip(state.inner, alone[i].inner):
                if isinstance(x, torch.Tensor):
                    _eq(x[i * N:(i + 1) * N], y.numpy())
