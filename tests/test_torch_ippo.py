"""Feed-forward IPPO and MAPPO: the port against the JAX package.

* one act step on the same weights (the port's init, converted), for ippo and mappo
  x shared weights on and off x matrix_game, spread and lbf: logits and
  values at 1e-5, log-probs of the same actions at 1e-5 (the two packages'
  action draws cannot agree, so each side's sampled actions are scored by
  the other) and greedy actions exactly;
* one full trainer ``update`` of ippo on spread from a rollout that a JAX
  Anakin run stored, converted across with its weights and optimizer
  state, with the JAX row permutations injected: params, Adam moments and
  the mean loss at 1e-5.  With 3 minibatches of the 40 rows one row sits
  out each epoch, as in the reference.  `tests/test_torch_mappo.py` runs
  the same check for mappo on lbf and matrix_game, with these helpers.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.system import _step_phase, _training_env, init_system_state  # noqa: E402
from repro.envs import make_env as jax_make_env  # noqa: E402
from repro.systems import onpolicy as jon  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.buffer import RolloutState  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.systems import onpolicy as ton  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-5
SMALL = dict(hidden_sizes=(16, 16), rollout_len=8, epochs=2)
N = 5  # 8 x 5 = 40 rows: 3 minibatches of 13 leave one row out
HORIZON = 5  # shorter than the rollout, so stored rollouts cross resets


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if hasattr(got, "detach") else got),
        np.asarray(want), atol=tol, rtol=tol,
    )


def _pair(system, env_name, **overrides):
    kw = dict(SMALL, **overrides)
    jsys = getattr(jon, f"make_{system}")(jax_make_env(env_name, horizon=HORIZON),
                                          jon.PPOConfig(**kw))
    tsys = getattr(ton, f"make_{system}")(make_env(env_name, horizon=HORIZON),
                                          ton.PPOConfig(**kw))
    return jsys, tsys


def _init_from_port(jsys, tsys, seed=3):
    """The port's freshly initialised `TrainState`, and the same in the reference's types.

    The reference's init compiles slowly on the CPU (orthogonal init), so
    the tests start both packages from the port's draws, converted across;
    the reference's tree, shapes and dtypes must match them.
    """
    ttrain = tsys.init_train(torch.Generator().manual_seed(seed))
    want = jax.eval_shape(jsys.init_train, jax.random.key(0))
    leaves = jax.tree_util.tree_leaves(params_to_jax(ttrain))
    for got, w in zip(leaves, jax.tree_util.tree_leaves(want), strict=True):
        assert got.shape == w.shape and got.dtype == w.dtype
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(want), leaves), ttrain


@pytest.mark.parametrize("env_name", ["matrix_game", "spread", "lbf"])
@pytest.mark.parametrize("system", ["ippo", "mappo"])
@pytest.mark.parametrize("shared_weights", [True, False])
def test_act_step_matches(env_name, system, shared_weights):
    jsys, tsys = _pair(system, env_name, shared_weights=shared_weights)
    cfg = dict(SMALL, shared_weights=shared_weights)
    centralised = system == "mappo"
    *_, jlogits, jvalue = jon.make_ppo_networks(jsys.env, jon.PPOConfig(**cfg), centralised)
    *_, tlogits, tvalue = ton.make_ppo_networks(tsys.env, ton.PPOConfig(**cfg), centralised)
    jtrain, ttrain = _init_from_port(jsys, tsys)
    ids = list(tsys.spec.agent_ids)
    assert set(ttrain.params["actor"]) == ({"shared"} if shared_weights else set(ids))

    spec = tsys.spec
    rng = np.random.default_rng(0)
    obs = {a: rng.normal(size=(N, *spec.observations[a].shape)).astype(np.float32) for a in ids}
    state = rng.normal(size=(N, *spec.state.shape)).astype(np.float32)
    key = jax.random.key(2)
    jgreedy, _, _ = jsys.select_actions(jtrain, obs, state, (), key, training=False)
    jact, _, jx = jsys.select_actions(jtrain, obs, state, (), key)

    tobs, tstate = params_from_jax(obs), torch.from_numpy(state)
    gen = torch.Generator().manual_seed(0)
    tgreedy, carry, extras = tsys.select_actions(ttrain, tobs, tstate, (), gen, training=False)
    assert carry == () and extras == {}
    tact, _, tx = tsys.select_actions(ttrain, tobs, tstate, (), gen)
    for a in ids:
        np.testing.assert_array_equal(tgreedy[a].numpy(), np.asarray(jgreedy[a]))
        assert tact[a].dtype == torch.int32 and tgreedy[a].dtype == torch.int32
        lg_j = jlogits(jtrain.params, a, obs[a])
        lg_t = tlogits(ttrain.params, a, tobs[a])
        _close(lg_t, lg_j)
        critic_in = state if centralised else obs[a]
        _close(tvalue(ttrain.params, a, torch.from_numpy(critic_in)),
               jvalue(jtrain.params, a, critic_in))
        _close(tx["value"][a], jx["value"][a])
        lp_j = jax.nn.log_softmax(lg_j)
        # each side's sampled actions, scored by the other side's log-probs
        _close(tx["logp"][a], jnp.take_along_axis(lp_j, tact[a].numpy()[:, None], -1)[:, 0])
        lp_t = torch.log_softmax(lg_t, -1)
        _close(ton._take(lp_t, torch.from_numpy(np.asarray(jact[a]))), jx["logp"][a])


@functools.cache
def _stored_rollout(system, env_name, num_envs=N, **overrides):
    """A full rollout buffer from a JAX Anakin run, and the update key.

    The act path does not read ``num_minibatches``, so the cases of one
    system and env share it.
    """
    jsys, tsys = _pair(system, env_name, **overrides)
    train, _ = _init_from_port(jsys, tsys)
    jsys = dataclasses.replace(jsys, init_train=lambda key: train)
    tenv = _training_env(jsys.env)
    st = jax.jit(lambda k: init_system_state(jsys, k, num_envs, train_env=tenv))(
        jax.random.key(3))

    def step(st, key):
        st, k_upd, _ = _step_phase(jsys, tenv, st, key)
        # keep one input type for the jitted step (some env leaves come back weak)
        strong = lambda x: (x if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)
                            else jnp.asarray(x, x.dtype))
        return jax.tree_util.tree_map(strong, st), k_upd

    step = jax.jit(step)
    for _ in range(SMALL["rollout_len"]):
        st, k_upd = step(st, st.key)
    assert int(st.buffer.t) == SMALL["rollout_len"]
    # the stored episodes cross an auto-reset boundary
    assert bool((st.buffer.storage.step_type[1:] == 0).any())
    return st, k_upd


def check_update(system, env_name, num_minibatches, monkeypatch):
    """One update of each package from the same stored rollout, the JAX row shuffles injected."""
    jsys, tsys = _pair(system, env_name, num_minibatches=num_minibatches)
    st, k_upd = _stored_rollout(system, env_name)
    jtrain, _, jm = jax.jit(jsys.update)(st.train, st.buffer, k_upd)

    rows = SMALL["rollout_len"] * N
    key, perms = k_upd, []
    for _ in range(SMALL["epochs"]):
        key, kp = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(kp, rows))))
    it = iter(perms)
    monkeypatch.setattr(ton, "_row_permutation", lambda n, g: next(it))
    buffer = RolloutState(params_from_jax(st.buffer.storage), int(st.buffer.t))
    ttrain, tbuf, tm = tsys.update(params_from_jax(st.train), buffer, torch.Generator())
    assert next(it, None) is None and tbuf.t == 0 and int(ttrain.steps) == 1
    check_trained(st.train, jtrain, jm, ttrain, tm)


def check_trained(start, jtrain, jm, ttrain, tm):
    """Params, optimizer state and the mean loss of the two updates agree at 1e-5."""
    got = jax.tree_util.tree_leaves(params_to_jax(ttrain.params))
    want = jax.tree_util.tree_leaves(jtrain.params)
    assert len(got) == len(want)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(start.params), want))
    assert moved > 1e-4  # the update did change the weights
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL, atol=TOL)
    got = jax.tree_util.tree_leaves(params_to_jax(ttrain.opt_state))
    want = jax.tree_util.tree_leaves(jtrain.opt_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("num_minibatches", [1, 3])
def test_update_matches(num_minibatches, monkeypatch):
    check_update("ippo", "spread", num_minibatches, monkeypatch)


def test_vtrace_is_not_ported():
    # V-trace and distributed_axis are ported now (tests/test_torch_vtrace.py holds them
    # against the reference): the flag builds, and the config's fields and defaults are the
    # reference's
    assert ton.make_ippo(make_env("spread"), ton.PPOConfig(use_vtrace=True)).name == "ippo"
    theirs = {f.name: f.default for f in dataclasses.fields(jon.PPOConfig)}
    assert {f.name: f.default for f in dataclasses.fields(ton.PPOConfig)} == theirs
