"""V-trace: the port against the JAX package.

* `vtrace_advantages` against `repro.systems.vtrace.vtrace_advantages` on
  seeded numpy inputs, with truncation levels below 1 so both clips bite,
  with and without seed lanes, at 1e-6;
* on-policy (behaviour = current) at ``lam = 1`` V-trace is the port's
  GAE, and a hugely off-policy step's correction is capped at ``clip_rho``;
* one ``use_vtrace`` update of ippo (spread) and of rec-IPPO (linear core,
  matrix_game) from a rollout a JAX Anakin run stored, its behaviour
  log-probs made stale by seeded noise, with the JAX shuffles injected:
  params, Adam moments and the mean loss at 1e-5.  The JAX side runs its
  scan as its own CPU system tests do (the associative-scan path
  ``default_interpret`` picks off a TPU); the port's goes through the
  scan's plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.systems.vtrace import vtrace_advantages as jax_vtrace  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.buffer import RolloutState  # noqa: E402
from repro_torch.core.types import Transition  # noqa: E402
from repro_torch.systems import onpolicy as ton  # noqa: E402
from repro_torch.systems.vtrace import vtrace_advantages  # noqa: E402
import test_torch_ippo as ff  # noqa: E402
import test_torch_rec_ippo as rec  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-6
UPDATE_TOL = 1e-5
# the clips bite: ratios range over exp(+-0.6), above and below both levels
VTRACE = dict(use_vtrace=True, vtrace_clip_rho=0.9, vtrace_clip_c=0.8)


def _inputs(rng, shape):
    """Seeded V-trace inputs of a ``(T, [S,] B)`` batch, behaviour log-probs off the current ones."""
    curr = rng.normal(size=shape).astype(np.float32)
    behaviour = (curr + rng.uniform(-0.6, 0.6, size=shape)).astype(np.float32)
    values = rng.normal(size=shape).astype(np.float32)
    last = rng.normal(size=shape[1:]).astype(np.float32)
    rewards = rng.normal(size=shape).astype(np.float32)
    disc = (0.99 * (rng.random(shape) > 0.1)).astype(np.float32)
    return curr, behaviour, values, last, rewards, disc


@pytest.mark.parametrize("shape", [(12, 5), (7, 3, 4), (1, 6)])
@pytest.mark.parametrize("clip_rho,clip_c,lam", [(0.9, 0.8, 0.95), (1.0, 1.0, 1.0),
                                                 (0.5, 0.7, 0.9)])
def test_vtrace_matches_the_reference(shape, clip_rho, clip_c, lam):
    args = _inputs(np.random.default_rng(sum(shape)), shape)
    kw = dict(clip_rho=clip_rho, clip_c=clip_c, lam=lam)
    want = jax_vtrace(*args, **kw)
    got = vtrace_advantages(*(torch.from_numpy(x) for x in args), **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


def test_vtrace_equals_the_ports_gae_on_policy_at_lam_one():
    curr, _, values, last, rewards, disc = _inputs(np.random.default_rng(0), (12, 5))
    t = torch.from_numpy
    adv, ret = vtrace_advantages(t(curr), t(curr), t(values), t(last), t(rewards), t(disc),
                                 lam=1.0)
    gamma = 0.99  # GAE takes the raw discount and multiplies by gamma itself
    gae = ton._make_gae(ton.PPOConfig(gamma=gamma, gae_lambda=1.0), ["a"])
    traj = Transition(obs={}, actions={}, rewards={"a": t(rewards)},
                      discount=t(disc) / gamma, next_obs={}, state=None, next_state=None,
                      extras={"value": {"a": t(values)}})
    g_adv, g_ret = gae(traj, {"a": t(last)})
    np.testing.assert_allclose(adv.numpy(), g_adv["a"].numpy(), atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), g_ret["a"].numpy(), atol=1e-5)


def test_vtrace_truncates_importance_ratios():
    T, B = 4, 1
    zeros = torch.zeros(T, B)
    adv, _ = vtrace_advantages(torch.full((T, B), 5.0), zeros, zeros, torch.zeros(B),
                               torch.ones(T, B), zeros, clip_rho=1.0)
    np.testing.assert_allclose(adv.numpy(), np.ones((T, B)), atol=1e-6)


def _stale(buffer, seed=7):
    """The stored rollout with its behaviour log-probs moved off the acting policy's."""
    rng = np.random.default_rng(seed)
    logp = {a: np.asarray(x) + rng.uniform(-0.6, 0.6, size=np.shape(x)).astype(np.float32)
            for a, x in buffer.storage.extras["logp"].items()}
    extras = dict(buffer.storage.extras, logp=logp)
    return buffer._replace(storage=buffer.storage._replace(extras=extras))


def _perms(key, epochs, n):
    out = []
    for _ in range(epochs):
        key, kp = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.permutation(kp, n))))
    return iter(out)


def _check(jtrain, jm, ttrain, tm, start):
    got = jax.tree_util.tree_leaves(params_to_jax(ttrain.params))
    want = jax.tree_util.tree_leaves(jtrain.params)
    assert len(got) == len(want)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(start.params), want))
    assert moved > 1e-4  # the update did change the weights
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=UPDATE_TOL, rtol=UPDATE_TOL)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_jax(ttrain.opt_state)),
                    jax.tree_util.tree_leaves(jtrain.opt_state), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), atol=UPDATE_TOL, rtol=UPDATE_TOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=UPDATE_TOL,
                               atol=UPDATE_TOL)


def test_ippo_vtrace_update_matches(monkeypatch):
    jsys, tsys = ff._pair("ippo", "spread", num_minibatches=3, **VTRACE)
    st, k_upd = ff._stored_rollout("ippo", "spread")
    buffer = _stale(st.buffer)
    jtrain, _, jm = jax.jit(jsys.update)(st.train, buffer, k_upd)
    it = _perms(k_upd, ff.SMALL["epochs"], ff.SMALL["rollout_len"] * ff.N)
    monkeypatch.setattr(ton, "_row_permutation", lambda n, g: next(it))
    tbuf = RolloutState(params_from_jax(buffer.storage), int(buffer.t))
    ttrain, tbuf, tm = tsys.update(params_from_jax(st.train), tbuf, torch.Generator())
    assert next(it, None) is None and tbuf.t == 0
    _check(jtrain, jm, ttrain, tm, st.train)


def test_rec_ippo_linear_vtrace_update_matches(monkeypatch):
    jsys, tsys = rec._pair(num_minibatches=2, **VTRACE)
    st, k_upd = rec._stored_rollout()
    buffer = _stale(st.buffer)
    jtrain, _, jm = jax.jit(jsys.update)(st.train, buffer, k_upd)
    it = _perms(k_upd, rec.SMALL["epochs"], rec.NUM_ENVS)
    monkeypatch.setattr(ton, "_env_permutation", lambda n, g: next(it))
    tbuf = RolloutState(params_from_jax(buffer.storage), int(buffer.t))
    ttrain, tbuf, tm = tsys.update(params_from_jax(st.train), tbuf, torch.Generator())
    assert next(it, None) is None and tbuf.t == 0
    _check(jtrain, jm, ttrain, tm, st.train)


def test_vtrace_differs_from_gae_off_policy():
    """The stale log-probs reach the update: V-trace's params differ from GAE's."""
    _, tgae = ff._pair("ippo", "spread", num_minibatches=1)
    _, tvt = ff._pair("ippo", "spread", num_minibatches=1, **VTRACE)
    st, _ = ff._stored_rollout("ippo", "spread")
    buffer = _stale(st.buffer)
    out = []
    for tsys in (tgae, tvt):
        tbuf = RolloutState(params_from_jax(buffer.storage), int(buffer.t))
        train, _, _ = tsys.update(params_from_jax(st.train), tbuf,
                                  torch.Generator().manual_seed(0))
        out.append(params_to_jax(train.params))
    diff = max(float(np.abs(a - b).max()) for a, b in
               zip(jax.tree_util.tree_leaves(out[0]), jax.tree_util.tree_leaves(out[1])))
    assert diff > 1e-5
