"""The port's runners, evaluator, stats, registry and MARL launcher.

* seed lanes: lane ``s`` of a ``num_seeds=3`` Anakin run is the single run
  with seed ``s``: its metrics over the first rollout and its params after
  the first update at 1e-5 (ippo, mappo and rec-MAPPO with the linear core),
  and over the replay fill and the first update (vdn on spread, and mad4pg
  on continuous spread), whose gate reads the table's Python-int fill: its
  losses and gradients at 1e-5, and the params after it at 1e-5 except
  where Adam's first step amplifies rounding (see the test);
* an interleaved evaluation equals the standalone `evaluate` from the same
  train state and the seed the runner drew for it (one run and lanes);
* the port's `evaluate` against ``repro.eval.evaluate`` on matrix_game from
  converted params: returns and lengths exactly (greedy actions, and the
  matrix_game reset draws nothing);
* ``eval/stats.py`` bitwise against ``repro.eval.stats``;
* `run_environment_loop` in training and greedy mode, the greedy one
  exactly against the reference's loop;
* the launcher on the CPU, and its raise without a device and CUDA;
* the registry's `compatibility` and `make_pair`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.system import run_environment_loop as jax_run_loop  # noqa: E402
from repro.envs import REGISTRY as JAX_ENVS  # noqa: E402
from repro.envs.matrix_game import MatrixGame as JaxMatrixGame  # noqa: E402
from repro.eval import evaluate as jax_evaluate  # noqa: E402
from repro.eval import stats as jstats  # noqa: E402
from repro.systems import onpolicy as jon  # noqa: E402
from repro.systems import registry as jreg  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import make_anakin, run_environment_loop, train_anakin  # noqa: E402
from repro_torch.envs import MatrixGame  # noqa: E402
from repro_torch.eval import evaluate, make_evaluator  # noqa: E402
from repro_torch.eval import stats as tstats  # noqa: E402
from repro_torch.launch import train_marl  # noqa: E402
from repro_torch.systems import maddpg as tmad  # noqa: E402
from repro_torch.systems import offpolicy as toff  # noqa: E402
from repro_torch.systems import onpolicy as ton  # noqa: E402
from repro_torch.systems import registry  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-5
SMALL = dict(hidden_sizes=(16, 16), rollout_len=8, epochs=2, num_minibatches=2)
NUM_ENVS = 4


# the replay family: the gate opens with the 4th iteration's rows
REPLAY_SMALL = dict(hidden_sizes=(16, 16), batch_size=8, buffer_capacity=64,
                    min_replay=4 * NUM_ENVS)


def _system(name, env, **overrides):
    replay = registry.REGISTRY[name].config_cls is not ton.PPOConfig
    kw = dict(REPLAY_SMALL if replay else SMALL, **overrides)
    if name.startswith("rec_"):
        kw.setdefault("recurrent_core", "linear")
    return registry.make_pair(name, env, env_kwargs={"horizon": 5}, **kw)[1]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def _record_grads(monkeypatch, module):
    """Record the ``(loss, grads)`` of every update the module's systems run."""
    seen, inner = [], module._value_and_grad

    def value_and_grad(*args):
        seen.append(inner(*args))
        return seen[-1]

    monkeypatch.setattr(module, "_value_and_grad", value_and_grad)
    return seen


def _grads_like_params(seen, name):
    """The recorded first update's gradients, as a tree shaped like the params."""
    if name == "mad4pg":  # the critic's, then the actor's
        return {"critic": seen[0][1], "actor": seen[1][1]}
    return seen[0][1]


@pytest.mark.parametrize("name,env", [
    ("ippo", "spread"), ("mappo", "lbf"), ("rec_mappo", "spread"),
    ("vdn", "spread"), ("mad4pg", "spread"),
])
def test_seed_lanes_equal_serial_runs(name, env, monkeypatch):
    system = _system(name, env)
    ppo = name in ("ippo", "mappo", "rec_mappo")
    if ppo:
        iters, updates = SMALL["rollout_len"], 1  # one rollout, then the first update
    else:  # the 4th iteration's rows open the gate: the first update follows them
        iters, updates = 4, 1
        seen = _record_grads(monkeypatch, tmad if name == "mad4pg" else toff)
    st, m = train_anakin(system, 0, iters, NUM_ENVS, num_seeds=3, device="cpu")
    loss = "critic_loss" if name == "mad4pg" else "loss"
    assert m["reward"].shape == (3, iters) and m[loss].shape == (3, updates)
    if ppo:
        assert st.train.steps.tolist() == [1, 1, 1] and st.buffer.t == 0
    else:  # one update count and one fill for every lane, on the host
        assert st.train.steps == updates and st.buffer.lanes == 3
        assert isinstance(st.buffer.size, int) and isinstance(st.buffer.insert_pos, int)
        assert st.buffer.size == iters * NUM_ENVS
        lane_grads = tree_leaves(_grads_like_params(seen, name))
    assert st.carry == () or tree_leaves(st.carry)[0].shape[:2] == (3, NUM_ENVS)
    assert st.env_state.length.shape == st.timestep.step_type.shape == (3, NUM_ENVS)
    for s in range(3):
        if not ppo:
            seen.clear()
        one, m1 = train_anakin(system, s, iters, NUM_ENVS, device="cpu")
        for k in m:
            _close(m[k][s], m1[k])
        if ppo:
            for x, y in zip(tree_leaves(st.train), tree_leaves(one.train), strict=True):
                _close(x[s], y)
            continue
        # the replay family: the update's gradients at 1e-5, then the state
        # after it at 1e-5.  One exception, mad4pg's alone: where its two
        # gradients differ and are within 1e-6 of zero, Adam's first step
        # lr * g / (|g| + 1e-8) turns their ~1e-9 rounding (a lane's bmm
        # against the single run's mm: the C51 logits of empty atoms) into
        # up to lr, so those params are held at twice the learning rate,
        # the size a first step can take
        grads = tree_leaves(_grads_like_params(seen, name))
        for x, y in zip(lane_grads, grads, strict=True):
            _close(x[s], y)
        tiny = iter([(g.abs() < 1e-6) & (x[s] != g) if name == "mad4pg"
                     else torch.zeros_like(g, dtype=torch.bool)
                     for x, g in zip(lane_grads, grads, strict=True)])
        cfg = registry.REGISTRY[name].config_cls()
        lr = max(getattr(cfg, f, 0.0) for f in ("learning_rate", "actor_lr", "critic_lr"))
        n_params = len(grads)  # the params lead the train state's leaves
        for i, (x, y) in enumerate(zip(tree_leaves(st.train), tree_leaves(one.train),
                                       strict=True)):
            if not isinstance(x, torch.Tensor):
                assert x == y
            elif i < n_params:
                t = next(tiny)
                err = (x[s] - y).abs()
                assert bool((err[~t] <= TOL + TOL * y.abs()[~t]).all()), float(err[~t].max())
                assert bool((err[t] <= 2 * lr).all())
            else:
                _close(x[s], y)
    # lanes are independent runs, not copies of one
    assert not torch.equal(m["reward"][0], m["reward"][1])


@pytest.mark.parametrize("num_seeds", [None, 2])
def test_interleaved_eval_equals_standalone_evaluate(num_seeds):
    system = _system("ippo", "lbf")
    iters = 2 * SMALL["rollout_len"]
    kw = dict(eval_episodes=5, eval_num_envs=3, num_seeds=num_seeds, device="cpu")
    _, _, ev = train_anakin(system, 4, iters, NUM_ENVS, eval_every=iters // 2, **kw)
    lead = () if num_seeds is None else (num_seeds,)
    assert ev.episode_return.shape == (*lead, 2, 5) and ev.episode_length.dtype == torch.int32
    # one evaluation, after the last iteration, against the same run without
    # it: the runner draws the evaluation's seed from the generator as it
    # stands after training
    st, _, ev = train_anakin(system, 4, iters, NUM_ENVS, eval_every=iters, **kw)
    st2, _ = train_anakin(system, 4, iters, NUM_ENVS, num_seeds=num_seeds, device="cpu")
    for x, y in zip(tree_leaves(st.train), tree_leaves(st2.train), strict=True):
        assert torch.equal(x, y)
    gens = st2.key if num_seeds else (st2.key,)
    seeds = [int(torch.randint(2**62, (), generator=g)) for g in gens]
    want = evaluate(system, st2.train, seeds if num_seeds else seeds[0], num_episodes=5,
                    num_envs=3, num_seeds=num_seeds, device="cpu")
    for x, y in zip(tree_leaves(ev), tree_leaves(want), strict=True):
        assert torch.equal(x[..., 0, :], y)
    # lane s of a lane evaluation is that lane's params evaluated alone
    if num_seeds:
        one = evaluate(system, tree_map(lambda x: x[1], st2.train.params), seeds[1],
                       num_episodes=5, num_envs=3, device="cpu")
        assert torch.equal(one.episode_return, want.episode_return[1])
    with pytest.raises(ValueError, match="multiple"):
        make_anakin(system, iters, NUM_ENVS, eval_every=3, device="cpu")


@pytest.mark.parametrize("name", ["ippo", "rec_mappo"])
def test_evaluate_matches_the_reference_on_matrix_game(name):
    cfg = dict(SMALL, recurrent_core="linear") if name == "rec_mappo" else SMALL
    jsys = getattr(jon, f"make_{name}")(JaxMatrixGame(horizon=6), jon.PPOConfig(**cfg))
    tsys = getattr(ton, f"make_{name}")(MatrixGame(horizon=6), ton.PPOConfig(**cfg))
    # trained a little on the port, so greedy actions vary with the observation
    st, _ = train_anakin(tsys, 1, 4 * SMALL["rollout_len"], NUM_ENVS, device="cpu")
    params = params_to_jax(st.train.params)
    want = jax_evaluate(jsys, params, jax.random.key(0), num_episodes=7, num_envs=3)
    got = evaluate(tsys, params_from_jax(params), 0, num_episodes=7, num_envs=3, device="cpu")
    np.testing.assert_array_equal(got.episode_return.numpy(), np.asarray(want.episode_return))
    np.testing.assert_array_equal(got.episode_length.numpy(), np.asarray(want.episode_length))
    for a in got.agent_returns:
        np.testing.assert_array_equal(got.agent_returns[a].numpy(),
                                      np.asarray(want.agent_returns[a]))
    assert got.episode_return.shape == (7,)
    with pytest.raises(ValueError):
        make_evaluator(tsys, num_episodes=0)


def test_stats_match_the_reference_bitwise():
    rng = np.random.default_rng(0)
    for shape in [(3, 17), (1, 3), (40,), (5, 64)]:
        scores = rng.normal(size=shape) * 10
        for fn in ("mean", "median", "iqm"):
            assert getattr(tstats, fn)(scores) == getattr(jstats, fn)(scores)
        assert (tstats.stratified_bootstrap_ci(scores, num_resamples=200, seed=3)
                == jstats.stratified_bootstrap_ci(scores, num_resamples=200, seed=3))
        assert tstats.aggregate(scores, num_resamples=100) == jstats.aggregate(
            scores, num_resamples=100)
    with pytest.raises(ValueError):
        tstats.mean(np.zeros((2, 2, 2)))


def test_run_environment_loop_trains_and_plays_greedy():
    cfg = dict(SMALL, num_minibatches=2)
    tsys = ton.make_ippo(MatrixGame(horizon=6), ton.PPOConfig(**cfg))
    train, buf, ev = run_environment_loop(tsys, 0, num_episodes=3, device="cpu")
    assert int(train.steps) == 18 // SMALL["rollout_len"] and buf.t == 18 % SMALL["rollout_len"]
    assert ev.episode_return.shape == (3,) and (ev.episode_length == 6).all()

    jsys = jon.make_ippo(JaxMatrixGame(horizon=6), jon.PPOConfig(**cfg))
    structure = jax.tree_util.tree_structure(jax.eval_shape(jsys.init_train, jax.random.key(0)))
    jtrain = jax.tree_util.tree_unflatten(structure, tree_leaves(params_to_jax(train)))
    _, _, want = jax_run_loop(jsys, jax.random.key(0), num_episodes=2, training=False,
                              train_state=jtrain)
    greedy, buf2, got = run_environment_loop(tsys, 0, num_episodes=2, training=False,
                                             train_state=train, device="cpu")
    assert greedy is train and buf2.t == 0
    np.testing.assert_array_equal(got.episode_return.numpy(), want.episode_return)
    np.testing.assert_array_equal(got.episode_length.numpy(), want.episode_length)


def test_launcher_on_the_cpu_and_without_a_device(monkeypatch, capsys):
    out = train_marl.main(["--system", "mappo", "--env", "lbf", "--runner", "anakin",
                           "--iterations", "16", "--num-envs", "4", "--num-seeds", "2",
                           "--eval-every", "8", "--eval-episodes", "4", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "env steps/s" in printed and "final greedy eval return" in printed
    assert out["env_steps"] == 16 * 4 * 2 and np.isfinite(out["eval_return"])
    out = train_marl.main(["--system", "rec_ippo", "--env", "matrix_game", "--runner", "loop",
                           "--iterations", "2", "--device", "cpu"])
    assert out["env_steps"] == 20
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_marl.main(["--system", "ippo", "--env", "spread", "--iterations", "8"])
    with pytest.raises(SystemExit):  # a flag the port does not take is refused
        train_marl.parse_args(["--log-every", "10"])


def test_registry_compatibility_and_make_pair():
    assert sorted(registry.REGISTRY) == sorted(jreg.REGISTRY)
    assert sorted(registry.ENV_REGISTRY) == sorted(JAX_ENVS)
    continuous = {"maddpg", "mad4pg"}
    for name in registry.REGISTRY:
        for env in ("matrix_game", "spread", "lbf"):
            runs = env == "spread" or name not in continuous
            assert (registry.compatibility(name, env) is None) == runs
            # the reference's reasons (or None), word for word, with and
            # without the continuous mode
            for kw in (None, {"continuous": True}):
                assert registry.compatibility(name, env, kw) == jreg.compatibility(name, env, kw)
            assert (registry.compatibility(name, env, {"continuous": True}) is None) == (
                env == "spread" and name in continuous)
    assert registry.compatibility("dial", "speaker_listener") == (
        "dial requires homogeneous agents (shared weights)")
    assert registry.compatibility("rec_madqn", "speaker_listener") is None
    with pytest.raises(KeyError):
        registry.compatibility("no_such_system", "spread")
    with pytest.raises(KeyError):
        registry.make_pair("dial", "no_such_env")
    with pytest.raises(ValueError, match="homogeneous"):
        registry.make_pair("rial", "speaker_listener")
    env, system = registry.make_pair("mappo", "lbf", rollout_len=16)
    assert system.name == "mappo" and system.spec.state.shape == (40,)
    assert system.env is env
    with pytest.raises(ValueError, match="incompatible"):
        registry.make_system("ippo", registry.ENV_REGISTRY["spread"](continuous=True))
