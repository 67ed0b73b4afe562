"""rec-IPPO (linear core) on matrix_game: the port against the JAX package.

* one act step on converted weights: logits, values, carries and greedy
  actions at 1e-5;
* one full trainer ``update`` from a rollout that a JAX Anakin run stored,
  converted across with its weights and optimizer state: the updated params
  at 1e-5 and the mean loss at 1e-5 (relative).  With one minibatch the
  env shuffle cannot change the result; with two, the JAX permutations are
  injected into the port;
* a short CPU ``train_anakin`` of the port, and the import rule: importing
  ``repro_torch`` loads neither ``jax`` nor ``repro`` and initialises no GPU.
"""
import dataclasses
import functools
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.system import _step_phase, _training_env, init_system_state  # noqa: E402
from repro.envs.matrix_game import MatrixGame as JaxMatrixGame  # noqa: E402
from repro.systems import onpolicy as jon  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import train_anakin  # noqa: E402
from repro_torch.core.buffer import RolloutState  # noqa: E402
from repro_torch.envs import MatrixGame  # noqa: E402
from repro_torch.eval import evaluate  # noqa: E402
from repro_torch.systems import onpolicy as ton  # noqa: E402

ACT_TOL = 1e-5
UPDATE_TOL = 1e-5
SMALL = dict(hidden_sizes=(16, 16), rollout_len=8, epochs=2, recurrent_core="linear")
NUM_ENVS = 4
HORIZON = 5  # shorter than the rollout, so stored windows cross a reset
AGENTS = ("agent_0", "agent_1")


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got.detach() if hasattr(got, "detach") else got),
        np.asarray(want), atol=tol, rtol=tol,
    )


def _pair(**overrides):
    kw = dict(SMALL, **overrides)
    jsys = jon.make_rec_ippo(JaxMatrixGame(horizon=HORIZON), jon.PPOConfig(**kw))
    tsys = ton.make_rec_ippo(MatrixGame(horizon=HORIZON), ton.PPOConfig(**kw))
    return jsys, tsys


@pytest.mark.parametrize("shared_weights", [True, False])
def test_act_step_matches(shared_weights):
    cfg = dict(SMALL, shared_weights=shared_weights)
    _, _, _, jactor, jcritic = jon.make_recurrent_ppo_networks(
        JaxMatrixGame(), jon.PPOConfig(**cfg), centralised=False
    )
    _, _, _, tactor, tcritic = ton.make_recurrent_ppo_networks(
        MatrixGame(), ton.PPOConfig(**cfg)
    )
    jsys, tsys = _pair(shared_weights=shared_weights)
    train = _stored_rollout()[0].train
    if not shared_weights:
        # one stack per agent, made unequal so a swap of agents would show
        train = train._replace(params={
            group: {a: jax.tree_util.tree_map(lambda x: x * (1.0 - 0.5 * i), p["shared"])
                    for i, a in enumerate(AGENTS)}
            for group, p in train.params.items()
        })
    params = train.params
    assert set(params["actor"]) == ({"shared"} if shared_weights else set(AGENTS))
    pt = params_from_jax(params)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(NUM_ENVS, 6)).astype(np.float32)
    h = rng.normal(size=(NUM_ENVS, 16)).astype(np.float32)
    reset = np.array([True, False, True, False])

    carry = jsys.initial_carry((NUM_ENVS,))
    carry = carry._replace(hidden=jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), carry.hidden))
    obs_d = {a: obs for a in AGENTS}
    gs = np.zeros((NUM_ENVS, 6), np.float32)

    def j_act(train, h, obs, reset, carry, key):
        """Net steps with a reset mask, then greedy and sampling act steps."""
        steps = [net.step(train.params, a, h, obs, reset)
                 for a in AGENTS for net in (jactor, jcritic)]
        obs_d = {a: obs for a in AGENTS}
        return (steps,
                jsys.select_actions(train, obs_d, gs, carry, key, training=False),
                jsys.select_actions(train, obs_d, gs, carry, key))

    j_steps, (ja, jc, _), (_, jc_train, jx) = jax.jit(j_act)(
        train, h, obs, reset, carry, jax.random.key(2))
    tnets = [(a, net) for a in AGENTS for net in (tactor, tcritic)]
    for (hj, yj), (a, tnet) in zip(j_steps, tnets):
        ht, yt = tnet.step(pt, a, torch.from_numpy(h), torch.from_numpy(obs),
                           torch.from_numpy(reset))
        _close(ht, hj, ACT_TOL)  # carries
        _close(yt, yj, ACT_TOL)  # logits / values

    args = (params_from_jax(train), params_from_jax(obs_d), torch.from_numpy(gs),
            params_from_jax(carry), torch.Generator().manual_seed(0))
    ta, tc, _ = tsys.select_actions(*args, training=False)
    for a in ja:
        np.testing.assert_array_equal(ta[a].numpy(), np.asarray(ja[a]))  # greedy actions
        _close(tc.hidden["actor"][a], jc.hidden["actor"][a], ACT_TOL)
    # sampling differs by generator; values and carries do not
    ta, tc, tx = tsys.select_actions(*args)
    for a in ja:
        _close(tx["value"][a], jx["value"][a], ACT_TOL)
        _close(tc.hidden["critic"][a], jc_train.hidden["critic"][a], ACT_TOL)
        assert ta[a].dtype == torch.int32


def _jax_train_from_port(jsys, tsys):
    """The port's freshly initialised `TrainState`, in the reference's types."""
    want = jax.eval_shape(jsys.init_train, jax.random.key(0))
    tstate = params_to_jax(tsys.init_train(torch.Generator().manual_seed(3)))
    leaves = jax.tree_util.tree_leaves(tstate)
    for got, w in zip(leaves, jax.tree_util.tree_leaves(want), strict=True):
        assert got.shape == w.shape and got.dtype == w.dtype
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(want), leaves)


@functools.cache
def _stored_rollout():
    """A full rollout buffer from a JAX Anakin run, and the update key.

    The run starts from the port's initial weights, converted across.  The
    act path does not depend on ``num_minibatches``, so every case of
    `test_update_matches` shares this one.
    """
    jsys, tsys = _pair()
    train = _jax_train_from_port(jsys, tsys)
    jsys = dataclasses.replace(jsys, init_train=lambda key: train)
    tenv = _training_env(jsys.env)
    st = jax.jit(lambda k: init_system_state(jsys, k, NUM_ENVS, train_env=tenv))(
        jax.random.key(3)
    )

    def step(st, key):
        st, k_upd, _ = _step_phase(jsys, tenv, st, key)
        # the env step returns some leaves weakly typed; a strong state keeps
        # one input type, so the step compiles once
        strong = lambda x: (x if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)
                            else jnp.asarray(x, x.dtype))
        return jax.tree_util.tree_map(strong, st), k_upd

    step = jax.jit(step)
    for _ in range(SMALL["rollout_len"]):
        st, k_upd = step(st, st.key)
    assert int(st.buffer.t) == SMALL["rollout_len"]
    return st, k_upd


@pytest.mark.parametrize("num_minibatches", [1, 2])
def test_update_matches(num_minibatches, monkeypatch):
    jsys, tsys = _pair(num_minibatches=num_minibatches)
    st, k_upd = _stored_rollout()
    # the update's episodes must cross an auto-reset boundary
    assert bool((st.buffer.storage.step_type[1:] == 0).any())
    jtrain, _, jm = jax.jit(jsys.update)(st.train, st.buffer, k_upd)

    key, perms = k_upd, []
    for _ in range(SMALL["epochs"]):
        key, kp = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(kp, NUM_ENVS))))
    it = iter(perms)
    monkeypatch.setattr(ton, "_env_permutation", lambda n, g: next(it))
    buffer = RolloutState(params_from_jax(st.buffer.storage), int(st.buffer.t))
    ttrain, tbuf, tm = tsys.update(params_from_jax(st.train), buffer, torch.Generator())

    assert next(it, None) is None and tbuf.t == 0 and int(ttrain.steps) == 1
    got = params_to_jax(ttrain.params)
    want = jax.tree_util.tree_map(np.asarray, jtrain.params)
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(st.train.params), flat_want))
    assert moved > 1e-4  # the update did change the weights
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, w, atol=UPDATE_TOL, rtol=UPDATE_TOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=UPDATE_TOL)
    _close(ttrain.opt_state[1].nu["actor"]["shared"]["core"]["proj"]["w"],
           jtrain.opt_state[1].nu["actor"]["shared"]["core"]["proj"]["w"], UPDATE_TOL)


def test_train_anakin_and_evaluate_on_cpu():
    _, tsys = _pair(epochs=1, num_minibatches=2)
    st, m = train_anakin(tsys, 0, 2 * SMALL["rollout_len"], NUM_ENVS, device="cpu")
    assert int(st.train.steps) == 2 and st.buffer.t == 0
    assert m["reward"].shape == (16,) and m["loss"].shape == (2,)
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    ev = evaluate(tsys, st.train, 0, num_episodes=6, num_envs=4, device="cpu")
    assert ev.episode_return.shape == (6,) and (ev.episode_length == HORIZON).all()
    # V-trace is ported (tests/test_torch_vtrace.py): the flag builds
    assert ton.make_rec_ippo(MatrixGame(), ton.PPOConfig(use_vtrace=True)).name == "rec_ippo"


def test_import_loads_no_jax_and_no_gpu():
    code = (
        "import pkgutil, importlib, sys, torch, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        # the MARL slice's modules are among them
        "new = ('envs.grid', 'envs.spread', 'envs.lbf', 'systems.ippo', 'systems.mappo',\n"
        "       'systems.registry', 'eval.stats', 'launch.train_marl', 'lanes')\n"
        "missing = [m for m in new if 'repro_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro', 'triton')\n"
        "       or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
