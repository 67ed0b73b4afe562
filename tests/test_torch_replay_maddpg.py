"""MADDPG and MAD4PG on continuous spread: the port against the JAX package.

From the same weights (the port's init, converted; targets from another
init) and replay rows, with the JAX draws injected (the Gaussian noise
into `_action_noise`, the sample indices into `sample_indices`):

* one act step: the noisy, clipped actions and the greedy (noise-free)
  actions at 1e-5;
* one ``update``: the critic and the actor loss and their gradients at
  1e-5 (gradients as in `tests/test_torch_replay_systems.py::close_grads`),
  the actor's taken w.r.t. the actor's leaves only, then both groups'
  params and optimizer states and the Polyak targets after it; with the
  registry's centralised critics, and with decentralised and networked
  ones (the paper's Block-4 architecture switch);
* registry entries, `make_pair`'s continuous mode, and the config's
  defaults.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import architectures as jarch  # noqa: E402
from repro.core import buffer as jbuf  # noqa: E402
from repro.envs import make_env as jax_make_env  # noqa: E402
from repro.systems import maddpg as jmad  # noqa: E402
from repro.systems.maddpg import MaddpgConfig as JCfg  # noqa: E402
from repro_torch.convert import params_from_jax, replay_train_to_jax  # noqa: E402
from repro_torch.core import architectures as tarch  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.systems import maddpg as tmad  # noqa: E402
from repro_torch.systems import registry  # noqa: E402
from test_torch_replay_systems import (  # noqa: E402
    HORIZON,
    N,
    ROWS,
    capture_grads,
    check_trained,
    close,
    close_grads,
    closure,
    filled_buffers,
    init_from_port,
    inject_samples,
    pair,
    random_rows,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SMALL = dict(hidden_sizes=(16, 16), batch_size=8, buffer_capacity=64, min_replay=8)
CONTINUOUS = {"continuous": True}


@pytest.mark.parametrize("name", ["maddpg", "mad4pg"])
def test_act_step_matches(name, monkeypatch):
    jsys, tsys = pair(name, "spread", CONTINUOUS, **SMALL)
    jtrain, ttrain = init_from_port(jsys, tsys)
    ids = list(tsys.spec.agent_ids)
    rng = np.random.default_rng(0)
    obs = {a: rng.normal(size=(N, *tsys.spec.observations[a].shape)).astype(np.float32)
           for a in ids}
    state = rng.normal(size=(N, *tsys.spec.state.shape)).astype(np.float32)
    key = jax.random.key(2)
    jgreedy, _, _ = jsys.select_actions(jtrain, obs, state, (), key, training=False)
    jact, _, _ = jsys.select_actions(jtrain, obs, state, (), key)
    # the reference's draws (maddpg.py:120-125), unscaled
    noise = [torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i), (N, 2))))
             for i in range(len(ids))]
    monkeypatch.setattr(tmad, "_action_noise", lambda *args: noise)
    tobs, tstate = params_from_jax(obs), torch.from_numpy(state)
    tgreedy, carry, extras = tsys.select_actions(ttrain, tobs, tstate, (), None, training=False)
    assert carry == () and extras == {}
    tact, _, _ = tsys.select_actions(ttrain, tobs, tstate, (), None)
    for a in ids:
        close(tgreedy[a], jgreedy[a])
        close(tact[a], jact[a])
        assert not torch.equal(tact[a], tgreedy[a])


IDS = ("agent_0", "agent_1", "agent_2")
ADJACENCY = ((1, 1, 0), (0, 1, 1), (1, 0, 1))
ARCHITECTURES = {  # the paper's Block-4 switch
    "decentralised": (jarch.DecentralisedPolicyActor(), tarch.DecentralisedPolicyActor()),
    "networked": (jarch.NetworkedQValueCritic(adjacency=ADJACENCY, agent_order=IDS),
                  tarch.NetworkedQValueCritic(adjacency=ADJACENCY, agent_order=IDS)),
}


@pytest.mark.parametrize("name,architecture", [
    ("maddpg", None), ("mad4pg", None), ("maddpg", "decentralised"), ("mad4pg", "networked"),
])
def test_update_matches(name, architecture, monkeypatch):
    if architecture is None:  # the registry's: centralised critics
        jsys, tsys = pair(name, "spread", CONTINUOUS, **SMALL)
    else:
        jarc, tarc = ARCHITECTURES[architecture]
        kw = dict(continuous=True, horizon=HORIZON)
        jsys = getattr(jmad, f"make_{name}")(jax_make_env("spread", **kw), JCfg(**SMALL), jarc)
        tsys = getattr(tmad, f"make_{name}")(make_env("spread", **kw),
                                             tmad.MaddpgConfig(**SMALL), tarc)
    jtrain, ttrain = init_from_port(jsys, tsys, steps=4)
    rows = random_rows(tsys.spec, np.random.default_rng(1), ROWS, continuous=True)
    jb, tb = filled_buffers(jsys, rows)
    key = jax.random.key(5)
    jtrain2, _, jm = jsys.update(jtrain, jb, key)
    batch = jbuf.buffer_sample(jb, key, SMALL["batch_size"])
    p, t = jtrain.params, jtrain.target_params
    jc, jcg = jax.value_and_grad(closure(jsys.update, "critic_loss_fn"))(p["critic"], p, t, batch)
    ja, jag = jax.value_and_grad(closure(jsys.update, "actor_loss_fn"))(p["actor"], p, batch)

    inject_samples(monkeypatch, key, ROWS, SMALL["batch_size"])
    seen = capture_grads(monkeypatch, tmad)
    ttrain2, tb2, tm = tsys.update(ttrain, tb, None)
    assert tb2 is tb and len(seen) == 2
    (closs, cgrads), (aloss, agrads) = seen
    close(closs, jc)
    close(aloss, ja)
    close(tm["critic_loss"], jm["critic_loss"])
    close(tm["actor_loss"], jm["actor_loss"])
    for got, want in ((cgrads, jcg), (agrads, jag)):
        got = replay_train_to_jax(ttrain._replace(params=got)).params
        close_grads(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want))
    # the targets moved by tau towards the new params, every update
    check_trained(jtrain, jtrain2, ttrain2)
    assert ttrain2.steps == 5


def test_registry_entries_and_continuous_mode():
    for name in ("maddpg", "mad4pg"):
        entry = registry.REGISTRY[name]
        assert entry.action_space == "continuous" and entry.config_cls is tmad.MaddpgConfig
        env, system = registry.make_pair(name, "spread")  # turns continuous on
        assert env.continuous and system.action_space == "continuous" and system.name == name
        with pytest.raises(ValueError, match="incompatible"):
            registry.make_system(name, registry.ENV_REGISTRY["spread"]())
    with pytest.raises(ValueError, match="incompatible"):
        registry.make_pair("vdn", "spread", env_kwargs=CONTINUOUS)


def test_config_defaults_match_the_reference():
    theirs = {f.name: f.default for f in dataclasses.fields(JCfg)}
    ours = {f.name: f.default for f in dataclasses.fields(tmad.MaddpgConfig)}
    assert theirs["distributed_axis"] is None  # ported: gradient sync over the axis's ranks
    assert ours == theirs
