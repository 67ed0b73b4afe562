"""rec-MADQN over sequence replay: the port against the JAX package.

Both packages start from the same weights (the port's init, converted
across; the targets from another init, so a sync shows) and the same
sequence table (JAX `seq_add` of numpy rows with stored carries and FIRST
rows mid-window, converted with `seq_buffer_from_jax`).  The random draws
are injected: the JAX eps-greedy draws into `rec_madqn._explore_draws`,
the JAX window indices into `core.buffer.sample_indices`.

* one act step for the GRU and the linear core, shared and per-agent
  stacks (speaker_listener's heterogeneous agents, and shared weights
  turned off): eps-greedy and greedy actions exactly, the new carry at
  1e-5, the incoming carry stored in the extras;
* one update of each: the loss and every gradient at 1e-5, then the
  params, optimizer state and targets at 1e-4, with and without the
  target sync;
* seed lanes against serial runs, and the config's defaults.

The reference's rec-MADQN milestone (tests/test_seq_replay.py:279, 5,000
iterations) takes longer than a test file may on the CPU here; chip_smoke
runs it on the card.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import buffer as jbuf  # noqa: E402
from repro.core.types import Carry as JaxCarry  # noqa: E402
from repro.core.types import Transition as JaxTransition  # noqa: E402
from repro.envs import make_env as jax_make_env  # noqa: E402
from repro.nn.recurrent import window_start_carry as jax_window_start_carry  # noqa: E402
from repro.systems import registry as jreg  # noqa: E402
from repro_torch.convert import params_from_jax, replay_train_to_jax, seq_buffer_from_jax  # noqa: E402
from repro_torch.core import buffer as tbuf  # noqa: E402
from repro_torch.core import train_anakin  # noqa: E402
from repro_torch.core.types import Carry  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.systems import rec_madqn as trec  # noqa: E402
from repro_torch.systems import registry  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_replay_systems import (  # noqa: E402
    capture_grads,
    close,
    close_grads,
    closure,
    init_from_port,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PARAM_TOL = 1e-4
SMALL = dict(hidden_sizes=(16,), seq_len=3, burn_in=2, buffer_capacity=32, batch_size=5,
             min_windows=2, target_update_period=3)
N = 4
HORIZON = 5
CASES = [  # (env, recurrent_core, shared_weights)
    ("matrix_game", "gru", True),
    ("matrix_game", "linear", True),
    ("spread", "linear", False),
    ("speaker_listener", "gru", True),  # heterogeneous: per-agent stacks all the same
    ("speaker_listener", "linear", True),
]


@functools.cache
def pair(env_name, core, shared):
    """rec-MADQN on the same env in both packages (one pair a case, so JAX compiles it once)."""
    kw = dict(SMALL, recurrent_core=core, shared_weights=shared)
    env_kw = {"horizon": HORIZON}
    jsys = jreg.make_system("rec_madqn", jax_make_env(env_name, **env_kw), **kw)
    tsys = registry.make_system("rec_madqn", make_env(env_name, **env_kw), **kw)
    return jsys, tsys


@functools.cache
def jax_update(case):
    """The reference's update, and the loss and gradients of its sampled windows, in one jit."""
    jsys, _ = pair(*case)
    loss_fn = closure(jsys.update, "loss_fn")
    initial_carry = closure(jsys.update, "initial_carry")

    def run(train, buffer, key):
        win = jbuf.seq_sample(buffer, key, SMALL["batch_size"])
        carry0 = jax_window_start_carry(win.extras, initial_carry, (SMALL["batch_size"],))
        grads = jax.value_and_grad(loss_fn)(train.params, train.target_params,
                                            win._replace(extras={}), carry0)
        return jsys.update(train, buffer, key), grads

    return jax.jit(run)


@functools.cache
def jax_buffer(case):
    """A reference sequence table holding 11 steps of numpy rows (12 windows)."""
    jsys, tsys = pair(*case)
    jb = jsys.init_buffer(N)
    observe = jax.jit(jsys.observe)
    for row in _rows(tsys.spec, np.random.default_rng(1), 16, 11):
        jb = observe(jb, row)
    return jb


def _rows(spec, rng, hidden, steps):
    """``steps`` JAX transitions of ``N`` envs: stored carries, FIRST rows, terminal discounts."""
    ids = list(spec.agent_ids)
    obs = lambda: {a: rng.normal(size=(N, *spec.observations[a].shape)).astype(np.float32)
                   for a in ids}
    out = []
    for _ in range(steps):
        step_type = rng.choice([0, 1, 1, 2], size=N).astype(np.int32)
        out.append(JaxTransition(
            obs=obs(),
            actions={a: rng.integers(0, spec.actions[a].num_values, N).astype(np.int32)
                     for a in ids},
            rewards={a: rng.normal(size=N).astype(np.float32) for a in ids},
            discount=(rng.random(N) > 0.3).astype(np.float32),
            next_obs=obs(),
            state=rng.normal(size=(N, *spec.state.shape)).astype(np.float32),
            next_state=rng.normal(size=(N, *spec.state.shape)).astype(np.float32),
            extras={"carry_in": JaxCarry(hidden={a: rng.normal(size=(N, hidden)).astype(
                np.float32) for a in ids})},
            step_type=step_type,
        ))
    return out


@pytest.mark.parametrize("env_name,core,shared", CASES)
def test_act_step_matches(env_name, core, shared, monkeypatch):
    jsys, tsys = pair(env_name, core, shared)
    steps = 5_000  # eps 0.525
    jtrain, ttrain = init_from_port(jsys, tsys, steps=steps)
    ids = list(tsys.spec.agent_ids)
    homogeneous = env_name != "speaker_listener"
    assert set(ttrain.params) == ({"shared"} if shared and homogeneous else set(ids))
    spec = tsys.spec
    rng = np.random.default_rng(0)
    obs = {a: rng.normal(size=(N, *spec.observations[a].shape)).astype(np.float32) for a in ids}
    state = rng.normal(size=(N, *spec.state.shape)).astype(np.float32)
    hidden = {a: rng.normal(size=(N, 16)).astype(np.float32) for a in ids}
    key = jax.random.key(2)
    jcarry = JaxCarry(hidden=hidden)
    jgreedy, jgc, jge = jsys.select_actions(jtrain, obs, state, jcarry, key, training=False)
    jact, jnc, jextras = jsys.select_actions(jtrain, obs, state, jcarry, key)
    rand, explore = [], []
    for i, a in enumerate(ids):  # the reference's draws (rec_madqn.py:184-187)
        k_rand, k_explore = jax.random.split(jax.random.fold_in(key, i))
        rand.append(torch.from_numpy(np.array(jax.random.randint(
            k_rand, (N,), 0, spec.actions[a].num_values))))
        explore.append(torch.from_numpy(np.array(jax.random.uniform(k_explore, (N,)))))
    monkeypatch.setattr(trec, "_explore_draws", lambda *args: (rand, explore))
    tobs, tstate, tcarry = params_from_jax(obs), torch.from_numpy(state), params_from_jax(jcarry)
    tgreedy, tgc, tge = tsys.select_actions(ttrain, tobs, tstate, tcarry, None, training=False)
    assert tge == {} and jge == {}
    tact, tnc, textras = tsys.select_actions(ttrain, tobs, tstate, tcarry, None)
    assert textras["carry_in"] is tcarry and isinstance(tnc, Carry)
    explored = torch.stack(explore) < trec.eps_at(trec.RecMadqnConfig(**SMALL), steps)
    assert explored.any() and not explored.all()
    for a in ids:
        assert tact[a].dtype == tgreedy[a].dtype == torch.int32
        np.testing.assert_array_equal(tgreedy[a].numpy(), np.asarray(jgreedy[a]))
        np.testing.assert_array_equal(tact[a].numpy(), np.asarray(jact[a]))
        close(tnc.hidden[a], jnc.hidden[a])
        close(tgc.hidden[a], jgc.hidden[a])


@pytest.mark.parametrize("env_name,core,shared", CASES)
@pytest.mark.parametrize("sync", [False, True])
def test_update_matches(env_name, core, shared, sync, monkeypatch):
    steps = SMALL["target_update_period"] - 1 if sync else 0
    jsys, tsys = pair(env_name, core, shared)
    jtrain, ttrain = init_from_port(jsys, tsys, steps=steps)
    jb = jax_buffer((env_name, core, shared))
    assert int(jb.size) == 12  # flushes after steps 5, 8 and 11
    tb = seq_buffer_from_jax(jb)
    key = jax.random.key(5)
    (jtrain2, _, jm), (jloss, jgrads) = jax_update((env_name, core, shared))(jtrain, jb, key)

    idx = np.array(jax.random.randint(key, (SMALL["batch_size"],), 0, int(jb.size)))
    monkeypatch.setattr(tbuf, "sample_indices", lambda s, g, n: torch.from_numpy(idx))
    seen = capture_grads(monkeypatch, trec)
    ttrain2, tb2, tm = tsys.update(ttrain, tb, None)
    assert tb2 is tb and len(seen) == 1
    loss, grads = seen[0]
    close(loss, jloss)
    close(tm["loss"], jm["loss"])
    assert tm["eps"] == pytest.approx(float(jm["eps"]), abs=0)
    close_grads(tree_leaves(replay_train_to_jax(ttrain._replace(params=grads)).params),
                jax.tree_util.tree_leaves(jgrads))
    got = jax.tree_util.tree_leaves(replay_train_to_jax(ttrain2))
    want = jax.tree_util.tree_leaves(jtrain2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w, PARAM_TOL)
    assert ttrain2.steps == int(jtrain2.steps) == steps + 1
    assert (ttrain2.target_params is ttrain2.params) == sync
    if not sync:
        assert ttrain2.target_params is ttrain.target_params


def test_seed_lanes_equal_serial_runs():
    system = registry.make_pair("rec_madqn", "spread", env_kwargs={"horizon": HORIZON},
                                **dict(SMALL, recurrent_core="linear"))[1]
    iters = 9  # windows flush after iterations 5 and 8: updates from iteration 5 on
    st, m = train_anakin(system, 0, iters, N, num_seeds=2, device="cpu")
    assert st.train.steps == 5 and st.buffer.lanes == 2 and st.buffer.size == 2 * N
    assert m["loss"].shape == (2, 5)
    assert tree_leaves(st.carry)[0].shape[:2] == (2, N)
    for s in range(2):
        one, m1 = train_anakin(system, s, iters, N, device="cpu")
        for k in m:
            np.testing.assert_allclose(m[k][s].numpy(), m1[k].numpy(), atol=1e-5, rtol=1e-5)
        for x, y in zip(tree_leaves(st.train.params), tree_leaves(one.train.params),
                        strict=True):
            np.testing.assert_allclose(x[s].numpy(), y.numpy(), atol=1e-5, rtol=1e-5)
        for x, y in zip(tree_leaves(st.buffer.storage), tree_leaves(one.buffer.storage)):
            np.testing.assert_array_equal(x[s].numpy(), y.numpy())


def test_config_defaults_and_window_checks_match_the_reference():
    from repro.systems.rec_madqn import RecMadqnConfig as JCfg

    theirs = {f.name: f.default for f in dataclasses.fields(JCfg)}
    ours = {f.name: f.default for f in dataclasses.fields(trec.RecMadqnConfig)}
    assert theirs["distributed_axis"] is None  # ported: gradient sync over the axis's ranks
    assert ours == theirs
    env = make_env("matrix_game")
    for bad in (dict(seq_len=0), dict(burn_in=-1), dict(stride=0)):
        with pytest.raises(ValueError):
            trec.make_rec_madqn(env, trec.RecMadqnConfig(**bad))
