"""MADQN, MADQN-fp, VDN and QMIX: the port against the JAX package.

Both packages start from the same weights (the port's init, converted
across; the targets from another init, so a sync shows) and the same
replay rows (numpy, from a seed).  The random draws are injected: the JAX
eps-greedy ``randint`` / ``uniform`` draws into the port's
`_explore_draws`, the JAX sample indices into `sample_indices`.

* one act step, for every system x matrix_game, spread and lbf x shared
  weights on and off: eps-greedy actions (eps 0.525, so some explore) and
  greedy actions exactly;
* the eps schedule in float32 and the config's defaults.

`tests/test_torch_replay_update.py` holds one ``update`` of each case, with
these helpers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.envs import make_env as jax_make_env  # noqa: E402
from repro.systems import registry as jreg  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    buffer_from_jax,
    params_from_jax,
    replay_train_to_jax,
)
from repro_torch.core import buffer as tbuf  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.systems import offpolicy as toff  # noqa: E402
from repro_torch.systems import registry  # noqa: E402
from repro_torch.systems.offpolicy import eps_at  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-5
SMALL = dict(hidden_sizes=(16, 16), batch_size=8, buffer_capacity=64, min_replay=8,
             target_update_period=3)
N = 6
ROWS = 40
HORIZON = 5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if hasattr(got, "detach") else got),
        np.asarray(want), atol=tol, rtol=tol,
    )


def close_grads(got, want):
    """Gradient leaves at 1e-5, absolute errors scaled by the leaf's largest entry.

    A gradient entry sums per-row terms as large as the leaf's largest
    entry; where they cancel (QMIX's hypernetworks on lbf's 40-wide state
    give entries of ~50 beside ones below 1), float32 rounding in another
    sum order leaves absolute errors of ~1e-5 of the terms, not of the sum.
    """
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=TOL,
                                   atol=TOL * max(1.0, float(np.abs(w).max())))


def pair(name, env_name, env_kwargs=None, **overrides):
    """The same registry system on the same env in both packages."""
    kw = dict(env_kwargs or {}, horizon=HORIZON)
    jsys = jreg.make_system(name, jax_make_env(env_name, **kw), **overrides)
    tsys = registry.make_system(name, make_env(env_name, **kw), **overrides)
    return jsys, tsys


def init_from_port(jsys, tsys, steps=0, seed=3):
    """The port's fresh `TrainState` (targets from another init) in both packages' types."""
    ttrain = tsys.init_train(torch.Generator().manual_seed(seed))
    other = tsys.init_train(torch.Generator().manual_seed(seed + 100))
    ttrain = ttrain._replace(target_params=other.params, steps=steps)
    want = jax.eval_shape(jsys.init_train, jax.random.key(0))
    leaves = jax.tree_util.tree_leaves(replay_train_to_jax(ttrain))
    for got, w in zip(leaves, jax.tree_util.tree_leaves(want), strict=True):
        assert got.shape == w.shape and got.dtype == w.dtype
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(want), leaves), ttrain


def random_rows(spec, rng, n, continuous=False):
    """``n`` replay rows of numpy draws, in the reference's `Transition` layout."""
    ids = list(spec.agent_ids)

    def obs():
        return {a: rng.normal(size=(n, *spec.observations[a].shape)).astype(np.float32)
                for a in ids}

    if continuous:
        actions = {a: rng.uniform(-1, 1, size=(n, *spec.actions[a].shape)).astype(np.float32)
                   for a in ids}
    else:
        actions = {a: rng.integers(0, spec.actions[a].num_values, size=(n,)).astype(np.int32)
                   for a in ids}
    return dict(
        obs=obs(), actions=actions,
        rewards={a: rng.normal(size=(n,)).astype(np.float32) for a in ids},
        discount=rng.integers(0, 2, size=(n,)).astype(np.float32),
        next_obs=obs(),
        state=rng.normal(size=(n, *spec.state.shape)).astype(np.float32),
        next_state=rng.normal(size=(n, *spec.state.shape)).astype(np.float32),
        extras={}, step_type=rng.integers(0, 3, size=(n,)).astype(np.int32),
    )


def filled_buffers(jsys, rows):
    """The JAX replay table with ``rows`` added, and the port's copy of it."""
    jb = jsys.init_buffer(N)
    jb = jsys.observe(jb, type(jb.storage)(**rows))
    return jb, buffer_from_jax(jb)


def closure(fn, name):
    """A function a reference closure captured, by name."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def inject_samples(monkeypatch, key, size, batch_size):
    """Feed the JAX sample indices of ``key`` to the port's table."""
    idx = np.array(jax.random.randint(key, (batch_size,), 0, size))
    monkeypatch.setattr(tbuf, "sample_indices", lambda s, g, n: torch.from_numpy(idx))


def capture_grads(monkeypatch, module):
    """Record every ``(loss, grads)`` the module's updates compute."""
    seen = []
    inner = module._value_and_grad

    def value_and_grad(*args):
        out = inner(*args)
        seen.append(out)
        return out

    monkeypatch.setattr(module, "_value_and_grad", value_and_grad)
    return seen


def check_trained(start, jtrain, ttrain):
    """Params, targets, optimizer state and the update count agree after the update."""
    got = jax.tree_util.tree_leaves(replay_train_to_jax(ttrain))
    want = jax.tree_util.tree_leaves(jtrain)
    assert len(got) == len(want)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(start.params),
                                jax.tree_util.tree_leaves(jtrain.params)))
    assert moved > 1e-4  # the update did change the weights
    for g, w in zip(got, want):
        close(g, w)
    assert ttrain.steps == int(jtrain.steps)


ENVS = ["matrix_game", "spread", "lbf"]
VALUE_SYSTEMS = ["madqn", "madqn-fp", "vdn", "qmix"]


@pytest.mark.parametrize("env_name", ENVS)
@pytest.mark.parametrize("name", VALUE_SYSTEMS)
@pytest.mark.parametrize("shared_weights", [True, False])
def test_act_step_matches(name, env_name, shared_weights, monkeypatch):
    jsys, tsys = pair(name, env_name, shared_weights=shared_weights, **SMALL)
    steps = 5_000  # eps 0.525 (and a fingerprint of it)
    jtrain, ttrain = init_from_port(jsys, tsys, steps=steps)
    ids = list(tsys.spec.agent_ids)
    assert set(ttrain.params["q"]) == ({"shared"} if shared_weights else set(ids))
    spec = tsys.spec
    rng = np.random.default_rng(0)
    obs = {a: rng.normal(size=(N, *spec.observations[a].shape)).astype(np.float32) for a in ids}
    state = rng.normal(size=(N, *spec.state.shape)).astype(np.float32)
    key = jax.random.key(2)
    jgreedy, _, _ = jsys.select_actions(jtrain, obs, state, (), key, training=False)
    jact, _, _ = jsys.select_actions(jtrain, obs, state, (), key)
    rand, explore = [], []
    for i, a in enumerate(ids):  # the reference's draws (offpolicy.py:116-119)
        k_rand, k_explore = jax.random.split(jax.random.fold_in(key, i))
        rand.append(torch.from_numpy(np.array(jax.random.randint(
            k_rand, (N,), 0, spec.actions[a].num_values))))
        explore.append(torch.from_numpy(np.array(jax.random.uniform(k_explore, (N,)))))
    monkeypatch.setattr(toff, "_explore_draws", lambda *args: (rand, explore))
    tobs, tstate = params_from_jax(obs), torch.from_numpy(state)
    tgreedy, carry, extras = tsys.select_actions(ttrain, tobs, tstate, (), None, training=False)
    assert carry == () and extras == {}
    tact, _, _ = tsys.select_actions(ttrain, tobs, tstate, (), None)
    eps = eps_at(toff.OffPolicyConfig(), steps)
    assert eps == float(np.float32(0.525))
    explored = torch.stack(explore) < eps
    assert explored.any() and not explored.all()
    for a in ids:
        assert tact[a].dtype == tgreedy[a].dtype == torch.int32
        np.testing.assert_array_equal(tgreedy[a].numpy(), np.asarray(jgreedy[a]))
        np.testing.assert_array_equal(tact[a].numpy(), np.asarray(jact[a]))


def test_eps_schedule_matches_the_reference_in_float32():
    cfg = toff.OffPolicyConfig()
    jsys = jreg.make_system("madqn", jax_make_env("matrix_game"))
    eps_fn = closure(jsys.select_actions, "eps_at")
    for steps in [0, 1, 333, 5_000, 9_999, 10_000, 123_456]:
        assert eps_at(cfg, steps) == float(eps_fn(jnp.int32(steps)))


def test_config_defaults_match_the_reference():
    from repro.systems.offpolicy import OffPolicyConfig as JCfg

    theirs = {f.name: f.default for f in dataclasses.fields(JCfg)}
    ours = {f.name: f.default for f in dataclasses.fields(toff.OffPolicyConfig)}
    assert theirs["distributed_axis"] is None  # ported: gradient sync over the axis's ranks
    assert ours == theirs
