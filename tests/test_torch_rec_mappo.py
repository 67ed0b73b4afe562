"""rec-MAPPO (centralised recurrent critics) on spread: the port against the JAX package.

For the linear core, whose BPTT runs through the recurrent-scan op
(`tests/test_torch_rec_mappo_gru.py` runs the same checks for the GRU
core):

* one act step on converted weights: the actor and critic cores' step
  (the critic reading spread's 18-wide global state) with a reset mask,
  values and carries at 1e-5, greedy actions exactly;
* one full trainer ``update`` from a rollout that a JAX Anakin run stored,
  with the JAX env-axis permutations injected: params, Adam moments and
  the mean loss at 1e-5, with one and with two sequence minibatches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.systems import onpolicy as jon  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.buffer import RolloutState  # noqa: E402
from repro_torch.systems import onpolicy as ton  # noqa: E402
from test_torch_ippo import (  # noqa: E402
    SMALL,
    _close,
    _init_from_port,
    _pair,
    _stored_rollout,
    check_trained,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N = 4  # sequences: two minibatches of two


def check_act_step(core):
    """One act step of both packages on the same converted weights."""
    jsys, tsys = _pair("rec_mappo", "spread", recurrent_core=core)
    cfg = dict(SMALL, recurrent_core=core)
    *_, jactor, jcritic = jon.make_recurrent_ppo_networks(jsys.env, jon.PPOConfig(**cfg), True)
    *_, tactor, tcritic = ton.make_recurrent_ppo_networks(tsys.env, ton.PPOConfig(**cfg), True)
    jtrain, ttrain = _init_from_port(jsys, tsys)
    ids = list(tsys.spec.agent_ids)
    assert ttrain.params["critic"]["shared"]["encoder"]["dense_0"]["w"].shape == (18, 16)
    rng = np.random.default_rng(0)
    obs = {a: rng.normal(size=(N, 14)).astype(np.float32) for a in ids}
    state = rng.normal(size=(N, 18)).astype(np.float32)
    h = rng.normal(size=(N, 16)).astype(np.float32)
    reset = np.array([True, False, True, False])
    carry = jax.tree_util.tree_map(lambda x: x + 0.5, jsys.initial_carry((N,)))

    @jax.jit
    def j_act(train, obs, state, h, reset, carry, key):
        """The core steps with a reset mask, then greedy and sampling act steps."""
        steps = [net.step(train.params, a, h, x, reset)
                 for a in ids for net, x in ((jactor, obs[a]), (jcritic, state))]
        return (steps,
                jsys.select_actions(train, obs, state, carry, key, training=False),
                jsys.select_actions(train, obs, state, carry, key))

    j_steps, (jgreedy, jc, _), (_, jc_train, jx) = j_act(
        jtrain, obs, state, h, reset, carry, jax.random.key(2))
    t_nets = [(a, net, x) for a in ids for net, x in ((tactor, obs[a]), (tcritic, state))]
    for (hj, yj), (a, tnet, x) in zip(j_steps, t_nets, strict=True):
        ht, yt = tnet.step(ttrain.params, a, *map(torch.from_numpy, (h, x, reset)))
        _close(ht, hj)
        _close(yt, yj)
    args = (ttrain, params_from_jax(obs), torch.from_numpy(state), params_from_jax(carry),
            torch.Generator().manual_seed(0))
    tgreedy, tc, _ = tsys.select_actions(*args, training=False)
    _, tc_train, tx = tsys.select_actions(*args)
    for a in ids:
        np.testing.assert_array_equal(tgreedy[a].numpy(), np.asarray(jgreedy[a]))
        _close(tc.hidden["actor"][a], jc.hidden["actor"][a])
        _close(tx["value"][a], jx["value"][a])
        _close(tc_train.hidden["critic"][a], jc_train.hidden["critic"][a])
        _close(tx["carry_in"].hidden["critic"][a], carry.hidden["critic"][a])


def check_update(core, num_minibatches, monkeypatch):
    """One update of each package from the same stored rollout, the JAX env shuffles injected."""
    jsys, tsys = _pair("rec_mappo", "spread", recurrent_core=core,
                       num_minibatches=num_minibatches)
    st, k_upd = _stored_rollout("rec_mappo", "spread", N, recurrent_core=core)
    jtrain, _, jm = jax.jit(jsys.update)(st.train, st.buffer, k_upd)

    key, perms = k_upd, []
    for _ in range(SMALL["epochs"]):
        key, kp = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(kp, N))))
    it = iter(perms)
    monkeypatch.setattr(ton, "_env_permutation", lambda n, g: next(it))
    buffer = RolloutState(params_from_jax(st.buffer.storage), int(st.buffer.t))
    ttrain, tbuf, tm = tsys.update(params_from_jax(st.train), buffer, torch.Generator())
    assert next(it, None) is None and tbuf.t == 0 and int(ttrain.steps) == 1
    check_trained(st.train, jtrain, jm, ttrain, tm)


def test_act_step_matches():
    check_act_step("linear")


@pytest.mark.parametrize("num_minibatches", [1, 2])
def test_update_matches(num_minibatches, monkeypatch):
    check_update("linear", num_minibatches, monkeypatch)
