"""The replay family under the port's runners, evaluator and launcher.

* ``updates_per_step=2`` equals two sequential updates after each acting
  step, and the update gate opens at ``min_replay`` rows;
* `run_environment_loop` with MADQN (`tests/test_system.py:35-52`): the
  trainer updates once the table holds ``min_replay`` rows, per-agent
  returns, and the greedy loop against the reference's exactly;
* greedy evaluation (``training=False``: eps 0 and no noise, the
  fingerprint from the train state's update count) against
  ``repro.eval.evaluate`` on matrix_game exactly, from converted params,
  bare and as a full train state;
* the launcher on the CPU: ``--system vdn --env spread`` and
  ``--system maddpg --env spread``, which turns the continuous mode on.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.system import run_environment_loop as jax_run_loop  # noqa: E402
from repro.core.types import TrainState as JTrainState  # noqa: E402
from repro.envs.matrix_game import MatrixGame as JaxMatrixGame  # noqa: E402
from repro.eval import evaluate as jax_evaluate  # noqa: E402
from repro.systems import registry as jreg  # noqa: E402
from repro_torch.convert import params_to_jax, replay_train_to_jax  # noqa: E402
from repro_torch.core import run_environment_loop, train_anakin  # noqa: E402
from repro_torch.core.system import _step_phase, _training_env, init_system_state  # noqa: E402
from repro_torch.eval import evaluate  # noqa: E402
from repro_torch.launch import train_marl  # noqa: E402
from repro_torch.systems import registry  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SMALL = dict(hidden_sizes=(16, 16), batch_size=8, buffer_capacity=64, min_replay=20)
# tests/test_system.py's FAST_CFG
FAST = dict(buffer_capacity=5_000, min_replay=100, batch_size=32, eps_decay_steps=2_000,
            target_update_period=50, learning_rate=1e-3)


@pytest.mark.parametrize("name,env", [("vdn", "spread"), ("mad4pg", "spread")])
def test_updates_per_step_two_equals_two_sequential_updates(name, env):
    _, one = registry.make_pair(name, env, **SMALL)
    if name == "vdn":
        _, two = registry.make_pair(name, env, updates_per_step=2, **SMALL)
    else:  # MaddpgConfig has no updates_per_step (nor has the reference's): set the System's
        two = dataclasses.replace(one, updates_per_step=2)
    iters, envs = 6, 4  # the gate opens at the 5th iteration (20 rows)
    st, m = train_anakin(two, 0, iters, envs, device="cpu")
    assert st.train.steps == 2 * (iters - 4) and isinstance(st.buffer.size, int)

    # the same run, two updates written out after each ready acting step
    tenv = _training_env(one.env)
    ref = init_system_state(one, torch.Generator().manual_seed(0), envs, tenv)
    updated = []
    for _ in range(iters):
        with torch.no_grad():
            ref, _ = _step_phase(one, tenv, ref)
        updated.append(one.can_sample(ref.buffer))
        if updated[-1]:
            for _ in range(2):
                train, buffer, last = one.update(ref.train, ref.buffer, ref.key)
                ref = ref._replace(train=train, buffer=buffer)
    assert updated == [False] * 4 + [True] * 2
    assert ref.train.steps == st.train.steps
    for x, y in zip(tree_leaves(st.train), tree_leaves(ref.train), strict=True):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    key = "loss" if name == "vdn" else "critic_loss"
    assert m[key].shape == (2,) and torch.equal(m[key][-1], last[key])


def test_run_environment_loop_with_madqn():
    _, system = registry.make_pair("madqn", "matrix_game", env_kwargs={"horizon": 10},
                                   **dict(FAST, min_replay=20))  # 4 episodes x 10 steps
    train, buf, ev = run_environment_loop(system, 0, num_episodes=4, device="cpu")
    assert ev.episode_return.shape == (4,) and bool(torch.isfinite(ev.episode_return).all())
    assert train.steps == 40 - 20 + 1  # an update after every row from the 20th
    assert (buf.size, buf.insert_pos) == (40, 40)
    assert set(ev.agent_returns) == set(system.spec.agent_ids)
    for r in ev.agent_returns.values():
        assert r.shape == (4,) and bool(torch.isfinite(r).all())
    assert (ev.episode_length == 10).all()

    # greedy play from the trained state, against the reference's loop
    jsys = jreg.make_system("madqn", JaxMatrixGame(horizon=10), **dict(FAST, min_replay=20))
    jtrain = JTrainState(*replay_train_to_jax(train))
    _, _, want = jax_run_loop(jsys, jax.random.key(0), num_episodes=2, training=False,
                              train_state=jtrain)
    greedy, buf2, got = run_environment_loop(system, 0, num_episodes=2, training=False,
                                             train_state=train, device="cpu")
    assert greedy is train and buf2.size == 0
    np.testing.assert_array_equal(got.episode_return.numpy(), want.episode_return)
    np.testing.assert_array_equal(got.episode_length.numpy(), want.episode_length)


@pytest.mark.parametrize("name", ["vdn", "qmix", "madqn-fp"])
def test_greedy_evaluation_matches_the_reference_on_matrix_game(name):
    _, tsys = registry.make_pair(name, "matrix_game", env_kwargs={"horizon": 6}, **SMALL)
    jsys = jreg.make_system(name, JaxMatrixGame(horizon=6), **SMALL)
    # trained a little on the port, so greedy actions vary with the observation
    st, _ = train_anakin(tsys, 1, 40, 4, device="cpu")
    assert st.train.steps == 36
    for params, jparams in [
        (st.train.params, params_to_jax(st.train.params)),          # bare: update count 0
        (st.train, JTrainState(*replay_train_to_jax(st.train))),    # the run's count
    ]:
        want = jax_evaluate(jsys, jparams, jax.random.key(0), num_episodes=7, num_envs=3)
        got = evaluate(tsys, params, 0, num_episodes=7, num_envs=3, device="cpu")
        np.testing.assert_array_equal(got.episode_return.numpy(),
                                      np.asarray(want.episode_return))
        np.testing.assert_array_equal(got.episode_length.numpy(),
                                      np.asarray(want.episode_length))


def test_launcher_runs_replay_systems_on_the_cpu(capsys):
    out = train_marl.main(["--system", "vdn", "--env", "spread", "--iterations", "40",
                           "--num-envs", "8", "--num-seeds", "2", "--eval-every", "20",
                           "--eval-episodes", "4", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "env steps/s" in printed and "vdn on spread" in printed
    assert out["env_steps"] == 40 * 8 * 2 and np.isfinite(out["eval_return"])
    # a continuous-control system turns on the env's continuous mode itself
    out = train_marl.main(["--system", "maddpg", "--env", "spread", "--iterations", "8",
                           "--num-envs", "4", "--eval-episodes", "4", "--device", "cpu"])
    assert np.isfinite(out["eval_return"])
    out = train_marl.main(["--system", "mad4pg", "--env", "spread", "--continuous",
                           "--runner", "loop", "--iterations", "1", "--device", "cpu"])
    assert out["env_steps"] == 25
    with pytest.raises(ValueError, match="no continuous-action mode"):
        train_marl.main(["--system", "vdn", "--env", "lbf", "--continuous", "--device", "cpu"])
