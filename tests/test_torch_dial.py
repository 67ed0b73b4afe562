"""DIAL and RIAL on the switch riddle: the port against the JAX package.

Both packages start from the same weights (the port's init, converted
across; the targets from another init) and the same stored rollout (JAX
`rollout_add` of numpy rows with stored carries and messages and FIRST
rows mid-window).  The random draws are injected: the eps-greedy action
and message-bit draws into `dial._explore_draws`, the DRU noise into
`dial._dru_noise`, computed from the keys the reference splits (the
executor's, and each BPTT step's for the online and the target re-run).

Three configurations: DIAL with the channel on (the sequential re-run),
RIAL (teacher-forced bits, message TD), and the fused no-channel DIAL
(linear core: one recurrent-scan call an agent).

* one act step each, training and greedy: actions and message bits
  exactly, the new hidden states and messages at 1e-5;
* one update each: the loss and every gradient at 1e-5, then the params,
  optimizer state and targets at 1e-4, with and without the target sync;
* seed lanes against serial runs, and the config's defaults.

`tests/test_torch_dial_milestone.py` holds the reference's DIAL and RIAL
milestones.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.types import Carry as JaxCarry  # noqa: E402
from repro.core.types import Transition as JaxTransition  # noqa: E402
from repro.envs import make_env as jax_make_env  # noqa: E402
from repro.systems import registry as jreg  # noqa: E402
from repro_torch.convert import params_from_jax, replay_train_to_jax  # noqa: E402
from repro_torch.core import train_anakin  # noqa: E402
from repro_torch.core.buffer import RolloutState  # noqa: E402
from repro_torch.core.types import Carry  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.systems import dial as tdial  # noqa: E402
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
SMALL = dict(hidden_dim=16, channel_size=2, target_update_period=3, eps_decay_updates=10)
N = 4
H = SMALL["hidden_dim"]
C = SMALL["channel_size"]
CASES = {  # name: (registry system, config overrides)
    "dial": ("dial", {}),
    "rial": ("rial", {}),
    "fused": ("dial", dict(use_comm=False, recurrent_core="linear")),
}


@functools.cache
def pair(case):
    """The case on switch_game in both packages (one pair a case, so JAX compiles it once)."""
    name, overrides = CASES[case]
    kw = dict(SMALL, **overrides)
    jsys = jreg.make_system(name, jax_make_env("switch_game"), **kw)
    tsys = registry.make_system(name, make_env("switch_game"), **kw)
    return jsys, tsys


def _carry(rng, ids):
    return JaxCarry(hidden={a: rng.normal(size=(N, H)).astype(np.float32) for a in ids},
                    message={a: rng.random((N, C)).astype(np.float32) for a in ids})


def _act_draws(key, ids, num_actions, rial):
    """The reference's executor draws (dial.py:158-189), in the port's hook layout."""
    k_dru, k_act = jax.random.split(key)
    rand, explore, bits, bit_explore, noise = [], [], [], [], []
    t = lambda x: torch.from_numpy(np.array(x))
    for i, _ in enumerate(ids):
        k_rand, k_explore = jax.random.split(jax.random.fold_in(k_act, i))
        rand.append(t(jax.random.randint(k_rand, (N,), 0, num_actions)))
        explore.append(t(jax.random.uniform(k_explore, (N,))))
        if rial:
            km_rand, km_explore = jax.random.split(jax.random.fold_in(k_dru, i))
            bits.append(t(jax.random.randint(km_rand, (N, C), 0, 2)))
            bit_explore.append(t(jax.random.uniform(km_explore, (N, C))))
        else:
            noise.append(t(jax.random.normal(jax.random.fold_in(k_dru, i), (N, C))))
    return [(rand, explore), (bits, bit_explore)], noise


@pytest.mark.parametrize("case", list(CASES))
def test_act_step_matches(case, monkeypatch):
    jsys, tsys = pair(case)
    steps = 5  # eps 0.525
    jtrain, ttrain = init_from_port(jsys, tsys, steps=steps)
    ids = list(tsys.spec.agent_ids)
    rng = np.random.default_rng(0)
    obs = {a: rng.normal(size=(N, 2)).astype(np.float32) for a in ids}
    state = rng.normal(size=(N, 7)).astype(np.float32)
    jcarry = _carry(rng, ids)
    key = jax.random.key(2)
    rial = case == "rial"
    explore_draws, noise = _act_draws(key, ids, 2, rial)
    draws = iter(explore_draws)
    monkeypatch.setattr(tdial, "_explore_draws", lambda *args: next(draws))
    monkeypatch.setattr(tdial, "_dru_noise", lambda *args: noise)
    tobs, tstate, tcarry = params_from_jax(obs), torch.from_numpy(state), params_from_jax(jcarry)
    assert tdial.dial_eps_at(tdial.DialConfig(**SMALL), steps) == pytest.approx(0.525, abs=1e-7)
    for training in (True, False):
        jact, jnc, jex = jsys.select_actions(jtrain, obs, state, jcarry, key, training=training)
        tact, tnc, tex = tsys.select_actions(ttrain, tobs, tstate, tcarry, None,
                                             training=training)
        assert isinstance(tnc, Carry) and tex["carry_in"] is tcarry
        assert sorted(tex) == sorted(jex)
        for a in ids:
            assert tact[a].dtype == torch.int32
            np.testing.assert_array_equal(tact[a].numpy(), np.asarray(jact[a]))
            close(tnc.hidden[a], jnc.hidden[a])
            close(tnc.message[a], jnc.message[a])
            close(tex["msgs"][a], jex["msgs"][a])
            if rial:
                np.testing.assert_array_equal(tex["msg_bits"][a].numpy(),
                                              np.asarray(jex["msg_bits"][a]))
        if not training and not rial:  # greedy execution thresholds the DRU to bits
            assert set(np.unique(tnc.message[ids[0]].numpy())) <= {0.0, 1.0}


def _rows(rng, ids, rial, steps):
    """``steps`` JAX transitions of ``N`` switch-game envs, with the executor's extras."""
    out = []
    for _ in range(steps):
        bits = {a: rng.integers(0, 2, (N, C)).astype(np.int32) for a in ids}
        msgs = ({a: bits[a].astype(np.float32) for a in ids} if rial else
                {a: rng.random((N, C)).astype(np.float32) for a in ids})
        extras = {"msgs": msgs, "carry_in": _carry(rng, ids)}
        if rial:
            extras["msg_bits"] = bits
        out.append(JaxTransition(
            obs={a: rng.normal(size=(N, 2)).astype(np.float32) for a in ids},
            actions={a: rng.integers(0, 2, N).astype(np.int32) for a in ids},
            rewards={a: rng.normal(size=N).astype(np.float32) for a in ids},
            discount=(rng.random(N) > 0.3).astype(np.float32),
            next_obs={a: rng.normal(size=(N, 2)).astype(np.float32) for a in ids},
            state=rng.normal(size=(N, 7)).astype(np.float32),
            next_state=rng.normal(size=(N, 7)).astype(np.float32),
            extras=extras,
            step_type=rng.choice([0, 1, 1, 2], size=N).astype(np.int32),
        ))
    return out


@functools.cache
def jax_rollout(case):
    """A full reference rollout (``rollout_len`` = the horizon, 6 steps) of numpy rows."""
    jsys, tsys = pair(case)
    jb = jsys.init_buffer(N)
    observe = jax.jit(jsys.observe)
    for row in _rows(np.random.default_rng(1), list(tsys.spec.agent_ids), case == "rial", 6):
        jb = observe(jb, row)
    return jb


@functools.cache
def jax_update(case):
    """The reference's update, and its loss and gradients, in one jit."""
    jsys, _ = pair(case)
    loss_fn = closure(jsys.update, "loss_fn")

    def run(train, buffer, key):
        grads = jax.value_and_grad(loss_fn)(train.params, train.target_params, buffer.storage,
                                            key)
        return jsys.update(train, buffer, key), grads

    return jax.jit(run)


def _bptt_noise(key, n, T):
    """The DRU noise of the reference's online and target re-runs (dial.py:262-303), in the
    order the port draws it: T online steps, then T target steps and the target's bootstrap."""
    out = []
    k1, k2 = jax.random.split(key)
    for k, boot in ((k1, False), (k2, True)):
        for _ in range(T):
            k, k_dru = jax.random.split(k)
            out.append([torch.from_numpy(np.array(jax.random.normal(
                jax.random.fold_in(k_dru, i), (N, C)))) for i in range(n)])
        if boot:
            out.append([torch.from_numpy(np.array(jax.random.normal(
                jax.random.fold_in(k, i), (N, C)))) for i in range(n)])
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("sync", [False, True])
def test_update_matches(case, sync, monkeypatch):
    steps = SMALL["target_update_period"] - 1 if sync else 0
    jsys, tsys = pair(case)
    jtrain, ttrain = init_from_port(jsys, tsys, steps=steps)
    jb = jax_rollout(case)
    key = jax.random.key(5)
    (jtrain2, jb2, jm), (jloss, jgrads) = jax_update(case)(jtrain, jb, key)
    assert int(jb2.t) == 0
    noise = iter(_bptt_noise(key, 3, 6) if case == "dial" else [])
    monkeypatch.setattr(tdial, "_dru_noise", lambda *args: next(noise))
    seen = capture_grads(monkeypatch, tdial)
    tb = RolloutState(params_from_jax(jb.storage), int(jb.t))
    ttrain2, tb2, tm = tsys.update(ttrain, tb, None)
    assert next(noise, None) is None  # every injected draw was used
    assert tb2.t == 0 and len(seen) == 1
    loss, grads = seen[0]
    close(loss, jloss)
    close(tm["loss"], jm["loss"])
    # under jit XLA fuses the reference's eps into one multiply-add: an ulp apart
    assert tm["eps"] == pytest.approx(float(jm["eps"]), rel=2e-7, abs=0)
    close_grads(tree_leaves(replay_train_to_jax(ttrain._replace(params=grads)).params),
                jax.tree_util.tree_leaves(jgrads))
    if case == "fused":  # the message head is off the loss: zeros, as jax.grad gives
        assert all(float(g.abs().max()) == 0 for g in tree_leaves(grads["msg_head"]))
    got = jax.tree_util.tree_leaves(replay_train_to_jax(ttrain2))
    want = jax.tree_util.tree_leaves(jtrain2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w, PARAM_TOL)
    assert ttrain2.steps == int(jtrain2.steps) == steps + 1
    assert (ttrain2.target_params is ttrain2.params) == sync


@pytest.mark.parametrize("case", list(CASES))
def test_seed_lanes_equal_serial_runs(case):
    _, tsys = pair(case)
    iters = 13  # two rollouts of 6, so two updates
    st, m = train_anakin(tsys, 0, iters, N, num_seeds=2, device="cpu")
    assert st.train.steps == 2 and m["loss"].shape == (2, 2)
    assert st.carry.message["agent_0"].shape == (2, N, C)
    for s in range(2):
        one, m1 = train_anakin(tsys, s, iters, N, device="cpu")
        for k in m:
            np.testing.assert_allclose(m[k][s].numpy(), m1[k].numpy(), atol=1e-5, rtol=1e-5)
        for x, y in zip(tree_leaves(st.train.params), tree_leaves(one.train.params),
                        strict=True):
            np.testing.assert_allclose(x[s].numpy(), y.numpy(), atol=1e-5, rtol=1e-5)


def test_config_defaults_and_names_match_the_reference():
    from repro.systems.dial import DialConfig as JCfg

    theirs = {f.name: f.default for f in dataclasses.fields(JCfg)}
    ours = {f.name: f.default for f in dataclasses.fields(tdial.DialConfig)}
    assert theirs["distributed_axis"] is None  # ported: gradient sync over the axis's ranks
    assert ours == theirs
    for case in CASES:
        jsys, tsys = pair(case)
        assert tsys.name == jsys.name
    cfg = tdial.DialConfig()
    eps_fn = closure(jreg.make_system("dial", jax_make_env("switch_game")).select_actions,
                     "eps_at")
    for steps in (0, 1, 150, 299, 300, 1000):
        assert tdial.dial_eps_at(cfg, steps) == float(eps_fn(np.int32(steps)))
