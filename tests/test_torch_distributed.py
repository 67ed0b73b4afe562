"""The sharded runner and gradient sync on torch.distributed: the port against the JAX package.

One spawned 2-rank gloo world on the CPU (a module fixture) runs every
case and writes its results; the tests then hold them against the JAX
package in this process:

* one update with ``distributed_axis="data"`` of ippo (spread), vdn
  (spread) and maddpg (continuous spread); rec-MADQN and DIAL are in
  `tests/test_torch_distributed_recurrent.py`, which uses this file's
  world.  Both ranks start from the same train state and update on their
  own data, with the reference's draws injected per rank; JAX runs
  ``jax.vmap(update, axis_name="data")`` over the same two converted
  states, whose ``pmean`` reduces across the vmapped axis.  The synced
  gradients (of the replay systems and DIAL) and the losses at 1e-5, the
  params and optimizer state after the update at each system's own
  single-rank tolerance (1e-5; 1e-4 for rec-MADQN and DIAL, whose
  single-rank tests hold them there), and both ranks' params equal
  bitwise;
* the runner at 2 ranks (`run_executor`, ippo and madqn on matrix_game):
  the Adam moments of both ranks equal bitwise, the initial params
  different between ranks as the reference's per-device init makes them
  (`repro/core/system.py:632-637`, which splits the train key per
  device), the returned params rank 0's, reward and eval return ``(2,)``;
* an axis no runner bound raises, and so do devices the backend cannot
  take.  `tests/test_torch_distributed_runner.py` holds a world of one
  rank against anakin and runs the launcher's ``--runner sharded``.

The world's ranks import this module to run `_world`, so it imports JAX
and the reference only inside the functions that build the cases.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import (  # noqa: E402
    params_from_jax,
    params_to_jax,
    ranks_from_jax,
    replay_train_from_jax,
)
from repro_torch.core import buffer as tbuf  # noqa: E402
from repro_torch.core.buffer import RolloutState  # noqa: E402
from repro_torch.core.system import run_executor  # noqa: E402
from repro_torch.distributed import collective  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.launch import train_marl  # noqa: E402
from repro_torch.systems import dial as tdial  # noqa: E402
from repro_torch.systems import onpolicy as ton  # noqa: E402
from repro_torch.systems import registry  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

WORLD = 2
JOIN_TIMEOUT_S = 120.0
PPO_SMOKE = dict(hidden_sizes=(16, 16), rollout_len=8, epochs=1, num_minibatches=2)
MADQN_SMOKE = dict(hidden_sizes=(16, 16), buffer_capacity=256, min_replay=16, batch_size=8,
                   eps_decay_steps=100)
# (system, env, config) of the runner cases, 16 iterations x 4 envs a rank
RUNNER_CASES = {"ippo": ("ippo", "matrix_game", PPO_SMOKE),
                "madqn": ("madqn", "matrix_game", MADQN_SMOKE)}
RUNNER_SEED, RUNNER_ITERATIONS, RUNNER_ENVS, RUNNER_EPISODES = 4, 16, 4, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------- the spawned world


def _build(recipe):
    name, env_name, env_kwargs, overrides = recipe
    return registry.make_system(name, make_env(env_name, **env_kwargs),
                                distributed_axis="data", **overrides)


def _world(rank, world_size, device, inputs_path):
    """Every case on one rank of the world: the update cases, then the runner cases."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    out = {}
    pmean = ton.pmean
    hooks = {"perm": (ton, "_row_permutation"), "idx": (tbuf, "sample_indices"),
             "noise": (tdial, "_dru_noise")}
    for name, case in inputs["updates"].items():
        system = _build(case["recipe"])
        draws = case["draws"][rank]
        saved = {k: getattr(*hooks[k]) for k in draws}
        synced = []
        try:
            for k, v in draws.items():
                it = iter(v)
                setattr(*hooks[k], lambda *args, it=it: next(it))
            ton.pmean = lambda tree, axis: synced.append(pmean(tree, axis)) or synced[-1]
            train, _, metrics = system.update(case["train"], case["buffers"][rank],
                                              torch.Generator().manual_seed(0))
        finally:
            ton.pmean = pmean
            for k, v in saved.items():
                setattr(*hooks[k], v)
        out[name] = {"train": train, "metrics": metrics, "synced": synced[0]}
    for name, (system_name, env_name, overrides) in inputs["runners"].items():
        system = _build((system_name, env_name, {}, overrides))
        res = run_executor(system, RUNNER_SEED, rank, RUNNER_ITERATIONS, RUNNER_ENVS,
                           eval_episodes=RUNNER_EPISODES, device=device)
        out["runner_" + name] = {k: v for k, v in res.items() if k != "state"}
        out["runner_" + name]["own"] = res["state"].train
    return out


# ------------------------------------------------- the cases, built with JAX


def _perms(key, epochs, n):
    import jax

    out = []
    for _ in range(epochs):
        key, kp = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.permutation(kp, n))))
    return out


def _stack(*trees):
    import jax

    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)


def _lane(tree, r):
    import jax

    return jax.tree_util.tree_map(lambda x: np.asarray(x)[r], tree)


def _keys():
    import jax

    return [jax.random.key(5), jax.random.key(6)]


def _random_rollout(jsys, spec, rng, T, N):
    """A full JAX rollout of numpy draws: the PPO family's stored `Transition` rows."""
    from repro.core.types import Transition

    ids = list(spec.agent_ids)
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)
    obs = lambda: {a: normal(T, N, *spec.observations[a].shape) for a in ids}
    storage = Transition(
        obs=obs(),
        actions={a: rng.integers(0, spec.actions[a].num_values, (T, N)).astype(np.int32)
                 for a in ids},
        rewards={a: normal(T, N) for a in ids},
        discount=(rng.random((T, N)) > 0.2).astype(np.float32),
        next_obs=obs(), state=normal(T, N, *spec.state.shape),
        next_state=normal(T, N, *spec.state.shape),
        extras={"logp": {a: -np.abs(normal(T, N)) - 0.1 for a in ids},
                "value": {a: normal(T, N) for a in ids}},
        step_type=rng.choice([0, 1, 1, 2], size=(T, N)).astype(np.int32),
    )
    return jsys.init_buffer(N)._replace(storage=storage, t=np.int32(T))


def _ippo_case():
    import jax
    import test_torch_ippo as ff

    jsys, tsys = ff._pair("ippo", "spread", num_minibatches=2, distributed_axis="data")
    jtrain, _ = ff._init_from_port(jsys, tsys)
    T, N = ff.SMALL["rollout_len"], ff.N
    buffers = [_random_rollout(jsys, tsys.spec, np.random.default_rng(r + 1), T, N)
               for r in range(WORLD)]
    keys = _keys()
    jtrain2, _, jm = jax.jit(jax.vmap(jsys.update, axis_name="data"))(
        _stack(jtrain, jtrain), _stack(*buffers), jax.numpy.stack(keys))
    return {
        "recipe": ("ippo", "spread", {"horizon": ff.HORIZON},
                   dict(ff.SMALL, num_minibatches=2)),
        "train": params_from_jax(jtrain),
        "buffers": [RolloutState(params_from_jax(b.storage), int(b.t)) for b in buffers],
        "draws": [{"perm": _perms(k, ff.SMALL["epochs"], T * N)} for k in keys],
        "jax": (jtrain2, jm, None), "tol": 1e-5, "replay": False,
    }


def _replay_case(name, env_kwargs, overrides, steps, loss_grads):
    """vdn or maddpg: the same train state, two tables of random rows, the sample indices."""
    import jax
    import test_torch_replay_systems as rs
    from repro.core import buffer as jbuf

    jsys, tsys = rs.pair(name, "spread", env_kwargs, distributed_axis="data", **overrides)
    jtrain, ttrain = rs.init_from_port(jsys, tsys, steps=steps)
    continuous = bool(env_kwargs)
    tables = [rs.filled_buffers(jsys, rs.random_rows(tsys.spec, np.random.default_rng(r + 1),
                                                     rs.ROWS, continuous=continuous))
              for r in range(WORLD)]
    keys = _keys()
    bs = overrides["batch_size"]

    def run(train, buffer, key):
        grads = loss_grads(jsys, train, jbuf.buffer_sample(buffer, key, bs))
        return jsys.update(train, buffer, key), jax.lax.pmean(grads, "data")

    (jtrain2, _, jm), jgrads = jax.jit(jax.vmap(run, axis_name="data"))(
        _stack(jtrain, jtrain), _stack(*[jb for jb, _ in tables]), jax.numpy.stack(keys))
    idx = [torch.from_numpy(np.array(jax.random.randint(k, (bs,), 0, rs.ROWS))) for k in keys]
    return {
        "recipe": (name, "spread", dict(env_kwargs or {}, horizon=rs.HORIZON), overrides),
        "train": ttrain, "buffers": [tb for _, tb in tables],
        "draws": [{"idx": [i]} for i in idx],
        "jax": (jtrain2, jm, jgrads), "tol": 1e-5, "replay": True,
    }


def _vdn_case():
    import jax
    import test_torch_replay_systems as rs

    closure = rs.closure

    def grads(jsys, train, batch):
        return jax.grad(closure(jsys.update, "loss_fn"))(train.params, train.target_params,
                                                         batch, train.steps)

    return _replay_case("vdn", None, rs.SMALL, 0, grads)


def _maddpg_case():
    import jax
    import test_torch_replay_maddpg as rm
    import test_torch_replay_systems as rs

    def grads(jsys, train, batch):
        p, t = train.params, train.target_params
        cg = jax.grad(rs.closure(jsys.update, "critic_loss_fn"))(p["critic"], p, t, batch)
        ag = jax.grad(rs.closure(jsys.update, "actor_loss_fn"))(p["actor"], p, batch)
        return cg, ag

    return _replay_case("maddpg", rm.CONTINUOUS, rm.SMALL, 4, grads)


CASES = {"ippo": _ippo_case, "vdn": _vdn_case, "maddpg": _maddpg_case}


def run_cases(builders, tmp_dir, runner_cases):
    """Build the cases with JAX, then run them (and the runner cases) in one 2-rank gloo world."""
    cases = {name: build() for name, build in builders.items()}
    path = os.path.join(tmp_dir, "inputs.pt")
    torch.save({"updates": {name: {k: c[k] for k in ("recipe", "train", "buffers", "draws")}
                            for name, c in cases.items()},
                "runners": runner_cases}, path)
    results = collective.run_world(_world, WORLD, "gloo", "cpu", args=(path,),
                                   timeout_s=JOIN_TIMEOUT_S)
    return cases, results


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case of this file, in one spawned 2-rank gloo world."""
    return run_cases(CASES, tmp_path_factory.mktemp("world"), RUNNER_CASES)


# -------------------------------------------------------------------- tests


def _close(got, want, tol):
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=tol,
                                   atol=tol * max(1.0, float(np.abs(w).max())))


def check_synced_update(world, name):
    """Rank ``r``'s update against lane ``r`` of the JAX vmap; both ranks' params equal."""
    import jax

    cases, results = world
    case = cases[name]
    jtrain, jm, jgrads = case["jax"]
    wants = ranks_from_jax(jtrain, convert=replay_train_from_jax if case["replay"]
                           else params_from_jax)
    for r in range(WORLD):
        got, want = results[r][name], wants[r]
        for k in jm:
            np.testing.assert_allclose(float(got["metrics"][k]), float(np.asarray(jm[k])[r]),
                                       rtol=1e-5, atol=1e-5)
        if jgrads is not None:  # the first synced gradients (ippo's update takes 2 steps)
            synced = got["synced"]
            if name == "maddpg":
                c, a = synced
                synced = {"critic": c, "actor": a}
                jg = _lane({"critic": jgrads[0], "actor": jgrads[1]}, r)
            else:
                jg = _lane(jgrads, r)
            _close(tree_leaves(params_to_jax(synced)), jax.tree_util.tree_leaves(jg), 1e-5)
        _close(tree_leaves(got["train"].params), tree_leaves(want.params), case["tol"])
        _close(tree_leaves(got["train"].opt_state), tree_leaves(want.opt_state), case["tol"])
        assert got["train"].steps == want.steps if case["replay"] else torch.equal(
            got["train"].steps, want.steps)
    # both ranks applied the same averaged gradients to the same params
    for x, y in zip(tree_leaves(results[0][name]["train"].params),
                    tree_leaves(results[1][name]["train"].params), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", list(CASES))
def test_synced_update_matches_jax_vmap_pmean(world, name):
    check_synced_update(world, name)


@pytest.mark.parametrize("name", list(RUNNER_CASES))
def test_runner_keeps_ranks_in_step_from_their_own_inits(world, name):
    _, results = world
    r0, r1 = results[0]["runner_" + name], results[1]["runner_" + name]
    # Adam moments (and the step counts) bitwise equal: the same synced gradients everywhere
    assert tree_leaves(r0["own"].opt_state) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(r0["own"].opt_state),
                                          tree_leaves(r1["own"].opt_state), strict=True))
    assert r0["own"].steps == r1["own"].steps and int(r0["own"].steps) > 0
    # each rank initialised from its own seed, so its params differ and stay apart
    system_name, env_name, overrides = RUNNER_CASES[name]
    system = registry.make_system(system_name, make_env(env_name), **overrides)
    inits = [system.init_train(torch.Generator().manual_seed(RUNNER_SEED + r)).params
             for r in range(WORLD)]
    gap = max(float((x - y).abs().max()) for x, y in zip(tree_leaves(inits[0]),
                                                         tree_leaves(inits[1])))
    assert gap > 0.1
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(r0["own"].params),
                                                     tree_leaves(r1["own"].params)))
    # the program returns rank 0's params, on every rank
    for res in (r0, r1):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(res["params"]),
                                                     tree_leaves(r0["own"].params), strict=True))
    assert r0["metrics"]["reward"].shape == (WORLD,) and r0["eval_return"].shape == (WORLD,)
    assert torch.equal(r0["eval_return"], r1["eval_return"])
    assert all(bool(torch.isfinite(v).all()) for v in r0["metrics"].values())


def test_unbound_axis_and_unfit_devices_raise():
    with pytest.raises(RuntimeError, match="no process group is bound"):
        collective.pmean({"g": torch.ones(2)}, "data")
    with pytest.raises(ValueError, match="nccl needs one CUDA device a rank"):
        collective.run_world(_world, 2, "nccl", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices, one a rank"):
            collective.rank_devices("cuda", 2)
        with pytest.raises(RuntimeError, match="CUDA devices, one a rank"):
            train_marl.main(["--runner", "sharded", "--num-executors", "2", "--device", "cuda"])
