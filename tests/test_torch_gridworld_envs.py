"""The port's spread, lbf, grid mechanics and observation wrappers against the JAX package.

Whole episodes start from JAX reset states converted across
(`repro_torch.convert.reset_from_jax`) and play the same numpy-drawn
action sequences in both packages under `EpisodeStats`: lbf's integer
state (positions, levels, food) must match exactly and its float32
rewards and observations at 1e-6; spread's floats at 1e-6.  The grid
functions run on hand-built collisions, and the port's own resets are
checked for the invariants the reference's draws keep.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.envs import grid as jgrid  # noqa: E402
from repro.envs import REGISTRY as JAX_ENVS  # noqa: E402
from repro.envs import make_env as jax_make_env  # noqa: E402
from repro.envs.spread import Spread as JaxSpread  # noqa: E402
from repro.envs.wrappers import EpisodeStats as JaxEpisodeStats  # noqa: E402
from repro_torch import lanes  # noqa: E402
from repro_torch.convert import reset_from_jax  # noqa: E402
from repro_torch.envs import (  # noqa: E402
    REGISTRY,
    EpisodeStats,
    LevelBasedForaging,
    Spread,
    StepType,
    make_env,
)
from repro_torch.envs import grid  # noqa: E402


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


def _actions(rng, spec, continuous):
    if continuous:  # beyond [-1, 1] too, so the force clip is exercised
        return {a: rng.normal(scale=1.5, size=(N, 2)).astype(np.float32) for a in spec.agent_ids}
    return {a: rng.integers(0, spec.actions[a].num_values, N).astype(np.int32)
            for a in spec.agent_ids}


def _play(jenv, tenv, steps, continuous=False, check_state=None, seed=0):
    """Reset both from the same JAX draw, then step both on the same actions."""
    jstate, jts = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(seed), N))
    tstate, tts = reset_from_jax((jstate, jts))
    jstep = jax.jit(jax.vmap(jenv.step))
    jgs = jax.jit(jax.vmap(jenv.global_state))
    rng = np.random.default_rng(seed)
    spec = tenv.spec()
    rewards = []
    for _ in range(steps):
        for a in spec.agent_ids:
            _close(tts.observation[a], jts.observation[a])
        _close(tenv.global_state(tstate), jgs(jstate))
        acts = _actions(rng, spec, continuous)
        jstate, jts = jstep(jstate, acts)
        tstate, tts = tenv.step(tstate, {a: torch.from_numpy(x) for a, x in acts.items()})
        _eq(tts.step_type, jts.step_type)
        _eq(tts.discount, jts.discount)
        for a in spec.agent_ids:
            _close(tts.reward[a], jts.reward[a])
            _close(tstate.last_returns[a], jstate.last_returns[a])
            assert tts.reward[a].dtype == torch.float32
        _eq(tstate.length, jstate.length)
        _eq(tstate.last_length, jstate.last_length)
        check_state(tstate.inner, jstate.inner)
        rewards.append(np.stack([np.asarray(jts.reward[a]) for a in spec.agent_ids]))
    assert tts.step_type.dtype == torch.int32
    return np.stack(rewards)


@pytest.mark.parametrize("continuous", [False, True])
def test_spread_episodes_match(continuous):
    env = Spread(continuous=continuous)
    assert REGISTRY["spread"](continuous=continuous) == env

    def check(t, j):
        _eq(t.t, j.t)
        for name in ("pos", "vel", "landmarks"):
            _close(getattr(t, name), getattr(j, name))

    rewards = _play(JaxEpisodeStats(JaxSpread(continuous=continuous)), EpisodeStats(env),
                    env.horizon + 2, continuous, check)
    assert (rewards < 0).all()


@pytest.mark.parametrize("shared_reward", [False, True])
@pytest.mark.parametrize("grid_size", [8, 3])  # 3: crowded, so agents collide and load often
def test_lbf_episodes_match(shared_reward, grid_size):
    kw = dict(shared_reward=shared_reward, grid_size=grid_size)
    jenv, tenv = JaxEpisodeStats(jax_make_env("lbf", **kw)), EpisodeStats(make_env("lbf", **kw))

    def check(t, j):
        for name in ("t", "pos", "levels", "food_pos", "food_level", "food_active"):
            _eq(getattr(t, name), getattr(j, name))
            assert getattr(t, name).dtype == {"food_active": torch.bool}.get(name, torch.int32)

    rewards = _play(jenv, tenv, 40, check_state=check, seed=grid_size)
    if grid_size == 3:  # the crowded grid collects food within the run
        assert (rewards > 0).any()
        if shared_reward:
            assert (rewards[:, 0] == rewards[:, 1]).all()


def test_grid_functions_on_hand_built_collisions():
    # env 0: both agents propose the same cell; env 1: agent 0 moves into agent 1's
    # current cell while agent 1 moves away; env 2: an edge clip and a free move
    pos = np.array([[[1, 1], [1, 3]], [[2, 2], [2, 3]], [[0, 0], [3, 3]]], np.int32)
    acts = np.array([[4, 3], [4, 1], [1, 1]], np.int32)
    cells = np.array([[[0, 2]], [[0, 0]], [[3, 3]]], np.int32)
    mask = np.array([[True], [True], [False]])

    jprop = jax.vmap(lambda p, a: jgrid.apply_moves(p, a, 4))(pos, acts)
    tprop = grid.apply_moves(torch.from_numpy(pos), torch.from_numpy(acts), 4)
    _eq(tprop, jprop)
    jhit = jax.vmap(jgrid.hits_cells)(jprop, cells, mask)
    thit = grid.hits_cells(tprop, torch.from_numpy(cells), torch.from_numpy(mask))
    _eq(thit, jhit)
    for blocked in (None, thit):
        if blocked is None:
            want = jax.vmap(lambda p, q: jgrid.resolve_collisions(p, q))(pos, jprop)
        else:
            want = jax.vmap(jgrid.resolve_collisions)(pos, jprop, jhit)
        got = grid.resolve_collisions(torch.from_numpy(pos), tprop, blocked)
        _eq(got, want)
        assert got.dtype == torch.int32
    # the contested moves are cancelled, the free one stays
    got = grid.resolve_collisions(torch.from_numpy(pos), tprop)
    _eq(got[0], pos[0])
    _eq(got[1], [[2, 2], [1, 3]])  # conservative: no entering a cell being vacated
    _eq(got[2], [[0, 0], [2, 3]])


def test_sample_distinct_cells_and_lbf_reset_invariants():
    env = LevelBasedForaging(num_agents=3, grid_size=3, num_food=4, max_level=3)
    g = torch.Generator().manual_seed(0)
    state, ts = env.reset(512, "cpu", g)
    cells = torch.cat([state.pos, state.food_pos], 1)
    flat = cells[..., 0] * 3 + cells[..., 1]
    assert all(len(set(row.tolist())) == 7 for row in flat)  # distinct within an env
    assert cells.dtype == torch.int32 and int(cells.min()) >= 0 and int(cells.max()) <= 2
    assert int(state.levels.min()) == 1 and int(state.levels.max()) == 3
    team = state.levels.sum(-1, keepdim=True)
    assert (state.food_level >= 1).all() and (state.food_level <= team).all()
    assert (state.food_level == team).any()  # the per-env upper bound is reached
    assert state.food_active.all() and (ts.step_type == StepType.FIRST).all()
    for a in env.agent_ids:
        assert ts.observation[a].shape == (512, env.obs_dim())


def test_lane_draws_equal_each_lane_drawn_alone():
    env = make_env("lbf")
    gens = lanes.generators([5, 7], "cpu")
    state, _ = env.reset(2 * N, "cpu", gens)
    for i, seed in enumerate((5, 7)):
        alone, _ = env.reset(N, "cpu", torch.Generator().manual_seed(seed))
        for x, y in zip(state, alone):
            _eq(x[i * N:(i + 1) * N], y.numpy())
    with pytest.raises(ValueError):
        env.reset(N + 1, "cpu", gens)


def test_agent_id_and_concat_obs_state_wrappers():
    jenv, tenv = jax_make_env("lbf"), make_env("lbf")
    jspec, tspec = jenv.spec(), tenv.spec()
    assert tspec.agent_ids == jspec.agent_ids
    for a in tspec.agent_ids:
        assert tspec.observations[a].shape == jspec.observations[a].shape == (3 + 12 + 3 + 2,)
    assert tspec.state.shape == jspec.state.shape == (2 * 20,)
    assert tenv.horizon == 32 and tenv.num_agents == 2  # attributes reach the inner env
    state, ts = tenv.reset(N, "cpu", torch.Generator().manual_seed(1))
    gs = tenv.global_state(state)
    # the global state is the concatenation of the id-augmented observations
    _eq(gs, torch.cat([ts.observation[a] for a in tspec.agent_ids], -1).numpy())
    for i, a in enumerate(tspec.agent_ids):
        _eq(ts.observation[a][:, -2:], np.eye(2, dtype=np.float32)[np.full(N, i)])
    # spread is registered bare: no ids, its own global state
    assert make_env("spread").spec().state.shape == jax_make_env("spread").spec().state.shape
    assert make_env("spread").spec().state.shape == (18,)


@pytest.mark.parametrize("name", ["smax_lite", "no_such_env"])
def test_make_env_raises_on_unported_or_unknown_names(name):
    # every env of the reference is ported: only a name it does not know raises
    unknown = name if name not in REGISTRY else f"{name}_v2"
    with pytest.raises(KeyError, match="registered"):
        make_env(unknown)
    assert sorted(REGISTRY) == sorted(JAX_ENVS)
    if name in REGISTRY:
        assert make_env(name).spec().agent_ids == jax_make_env(name).spec().agent_ids
