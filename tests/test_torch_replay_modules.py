"""The replay family's building blocks: the port against the JAX package.

Numpy inputs from a seed go through the reference function and its port,
at 1e-5 (float32 sums in another order), mirroring the reference's own
cases (`tests/test_mixing.py`, `tests/test_marl_modules.py:40-95`):

* mixing: VDN's exact sum; QMIX from converted JAX params (init keys,
  shapes and order) on single rows, batches and seed lanes, its
  monotonicity in the agents' Q-values and its use of the state;
* the fingerprint's appended ``[eps, step * 1e-4]``;
* the three architectures' critic inputs and `one_hot_actions`;
* MAD4PG's C51 projection (`repro/systems/maddpg.py:135-150`), with target
  atoms clipped at both ends of the support and atoms landing on a support
  point (the ``lo == hi`` term).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import architectures as jarch  # noqa: E402
from repro.core.modules.mixing import AdditiveMixing as JAdditive  # noqa: E402
from repro.core.modules.mixing import MonotonicMixing as JMonotonic  # noqa: E402
from repro.core.modules.stabilisation import FingerPrintStabilisation as JFingerPrint  # noqa: E402
from repro.envs import make_env as jax_make_env  # noqa: E402
from repro.systems.maddpg import MaddpgConfig as JMaddpgConfig  # noqa: E402
from repro.systems.maddpg import make_mad4pg as jax_make_mad4pg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import architectures as tarch  # noqa: E402
from repro_torch.core.modules import (  # noqa: E402
    AdditiveMixing,
    FingerPrintStabilisation,
    MonotonicMixing,
)
from repro_torch.lanes import stack  # noqa: E402
from repro_torch.systems.maddpg import project_distribution  # noqa: E402

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def test_vdn_is_the_sum():
    rng = np.random.default_rng(0)
    for n, lead in [(2, ()), (3, (7,)), (5, (2, 4))]:
        qs = (rng.normal(size=(*lead, n)) * 10).astype(np.float32)
        state = rng.normal(size=(*lead, 4)).astype(np.float32)
        want = JAdditive().apply(JAdditive().init(jax.random.key(0), n, 4), qs, state)
        mixer = AdditiveMixing()
        params = mixer.init(torch.Generator(), n, 4)
        assert params == {}
        _close(mixer.apply(params, torch.from_numpy(qs), torch.from_numpy(state)), want)


@pytest.mark.parametrize("n,state_dim,embed", [(2, 6, 32), (3, 54, 8), (5, 1, 4)])
def test_qmix_matches_from_converted_params(n, state_dim, embed):
    jmix = JMonotonic(embed_dim=embed)
    jparams = jmix.init(jax.random.key(n), n, state_dim)
    tmix = MonotonicMixing(embed_dim=embed)
    ours = tmix.init(torch.Generator().manual_seed(0), n, state_dim)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    # the bias-free hyper_b1 and the biases start at zero, as in the reference
    assert not ours["hyper_b1"].any() and not ours["hyper_b2_1b"].any()
    params = params_from_jax(jparams)
    rng = np.random.default_rng(n)
    for lead in [(), (9,), (2, 3)]:
        qs = (rng.normal(size=(*lead, n)) * 5).astype(np.float32)
        state = rng.normal(size=(*lead, state_dim)).astype(np.float32)
        _close(tmix.apply(params, torch.from_numpy(qs), torch.from_numpy(state)),
               jmix.apply(jparams, qs, state))
    # seed lanes: (S, ...) params on (S, B, ...) inputs, one product a layer
    lane_params = [jmix.init(jax.random.key(10 + s), n, state_dim) for s in range(3)]
    qs = (rng.normal(size=(3, 6, n)) * 5).astype(np.float32)
    state = rng.normal(size=(3, 6, state_dim)).astype(np.float32)
    got = tmix.apply(stack([params_from_jax(p) for p in lane_params]),
                     torch.from_numpy(qs), torch.from_numpy(state))
    for s in range(3):
        _close(got[s], jmix.apply(lane_params[s], qs[s], state[s]))


@pytest.mark.parametrize("seed", range(8))
def test_qmix_is_monotone_in_agent_qs(seed):
    """dQ_tot/dQ_i >= 0 for every agent: the QMIX representational guarantee."""
    rng = np.random.default_rng(seed)
    n, state_dim = 2 + seed % 4, 1 + seed
    mixer = MonotonicMixing(embed_dim=8, hypernet_hidden=16)
    params = mixer.init(torch.Generator().manual_seed(seed), n, state_dim)
    qs = torch.tensor(rng.normal(size=(n,)) * 5, dtype=torch.float32, requires_grad=True)
    state = torch.tensor(rng.normal(size=(state_dim,)), dtype=torch.float32)
    (grad,) = torch.autograd.grad(mixer.apply(params, qs, state), qs)
    assert bool((grad >= -1e-6).all()), grad


def test_qmix_uses_state():
    mixer = MonotonicMixing(embed_dim=8)
    params = mixer.init(torch.Generator().manual_seed(0), 3, 4)
    qs = torch.tensor([1.0, -2.0, 0.5])
    out1 = mixer.apply(params, qs, torch.ones(4))
    out2 = mixer.apply(params, qs, -torch.ones(4))
    assert abs(float(out1 - out2)) > 1e-6


@pytest.mark.parametrize("eps,step", [(0.3, 100), (1.0, 0), (0.05, 12_345)])
def test_fingerprint_appends_eps_and_scaled_step(eps, step):
    rng = np.random.default_rng(step)
    obs = {"a": rng.normal(size=(5, 3)).astype(np.float32),
           "b": rng.normal(size=(2, 4, 6)).astype(np.float32)}
    want = JFingerPrint().augment(obs, eps=jnp.float32(eps), step=jnp.asarray(step, jnp.int32))
    fp = FingerPrintStabilisation()
    got = fp.augment(params_from_jax(obs), eps, step)
    assert fp.size == 2 and got["a"].shape == (5, 5) and got["b"].shape == (2, 4, 8)
    for a in obs:
        np.testing.assert_array_equal(got[a].numpy(), np.asarray(want[a]))


def _arch_inputs(rng, lead):
    obs = {f"agent_{i}": rng.normal(size=(*lead, 4)).astype(np.float32) for i in range(3)}
    acts = {f"agent_{i}": rng.normal(size=(*lead, 2)).astype(np.float32) for i in range(3)}
    gs = rng.normal(size=(*lead, 6)).astype(np.float32)
    return obs, acts, gs


@pytest.mark.parametrize("lead", [(), (5,), (2, 3)])
def test_architectures_build_the_reference_inputs(lead):
    rng = np.random.default_rng(len(lead))
    obs, acts, gs = _arch_inputs(rng, lead)
    tobs, tacts, tgs = params_from_jax((obs, acts, gs))
    order = ("agent_0", "agent_1", "agent_2")
    adj = ((1, 0, 1), (1, 1, 0), (0, 0, 1))
    pairs = [
        (jarch.DecentralisedPolicyActor(), tarch.DecentralisedPolicyActor()),
        (jarch.CentralisedQValueCritic(agent_order=order),
         tarch.CentralisedQValueCritic(agent_order=order)),
        (jarch.CentralisedQValueCritic(), tarch.CentralisedQValueCritic()),
        (jarch.NetworkedQValueCritic(adjacency=adj, agent_order=order),
         tarch.NetworkedQValueCritic(adjacency=adj, agent_order=order)),
    ]
    for j, t in pairs:
        for a in order:
            want = j.critic_input(obs, acts, gs, a)
            got = t.critic_input(tobs, tacts, tgs, a)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(t.policy_input(tobs, a).numpy(),
                                          np.asarray(j.policy_input(obs, a)))
    # the networked critic zero-masks non-neighbours (agent_0 does not see agent_1)
    out0 = pairs[3][1].critic_input(tobs, tacts, tgs, "agent_0")
    assert not out0[..., 6:12].any()


def test_one_hot_actions_match():
    rng = np.random.default_rng(0)
    acts = {"a": rng.integers(0, 5, size=(7,)).astype(np.int32),
            "b": rng.integers(0, 3, size=(2, 4)).astype(np.int32)}
    nums = {"a": 5, "b": 3}
    want = jarch.one_hot_actions(acts, nums)
    got = tarch.one_hot_actions(params_from_jax(acts), nums)
    for a in acts:
        assert got[a].dtype == torch.float32
        np.testing.assert_array_equal(got[a].numpy(), np.asarray(want[a]))


def _closure(fn, name):
    """A variable a reference closure captured, by name (the reference keeps
    the C51 projection inside `make_maddpg`)."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def test_c51_projection_matches_the_reference():
    cfg = JMaddpgConfig(hidden_sizes=(8,))
    jsys = jax_make_mad4pg(jax_make_env("spread", continuous=True), cfg)
    jproject = _closure(_closure(jsys.update, "critic_loss_fn"), "_project_distribution")
    A = cfg.num_atoms
    atoms = np.linspace(cfg.v_min, cfg.v_max, A).astype(np.float32)
    dz = (cfg.v_max - cfg.v_min) / (A - 1)
    rng = np.random.default_rng(0)
    B = 12
    logits = rng.normal(size=(B, A)).astype(np.float32)
    probs = np.array(jax.nn.softmax(logits, axis=-1))
    r = rng.normal(size=(B,)).astype(np.float32) * 5
    r[0], r[1] = 400.0, -400.0        # every target atom clipped to v_max / v_min
    r[2] = cfg.v_min + 30 * dz         # with discount 0 below: on a support point
    r[3] = cfg.v_min                   # the bottom support point exactly (lo == hi)
    discount = rng.integers(0, 2, size=(B,)).astype(np.float32)
    discount[2] = discount[3] = 0.0
    target_atoms = r[:, None] + cfg.gamma * discount[:, None] * atoms[None]
    want = np.asarray(jproject(probs, target_atoms))
    got = project_distribution(torch.from_numpy(probs), torch.from_numpy(target_atoms),
                               cfg.v_min, cfg.v_max)
    _close(got, want)
    # mass is conserved, and the clipped rows land on the ends of the support
    _close(got.sum(-1), np.ones(B))
    assert float(got[0, -1]) == pytest.approx(1.0, abs=1e-6)
    assert float(got[1, 0]) == pytest.approx(1.0, abs=1e-6)
    # seed lanes are one more batch axis
    lane = project_distribution(torch.from_numpy(probs).reshape(3, 4, A),
                                torch.from_numpy(target_atoms).reshape(3, 4, A),
                                cfg.v_min, cfg.v_max)
    _close(lane.reshape(B, A), want)
