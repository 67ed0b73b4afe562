"""The sharded runner's entry points on the CPU, and the reference behaviour it reproduces.

* the reference's per-device init (`repro/core/system.py:632-637`)
  splits the train key per device, so the devices start from different
  params; the port's ranks start from their own seeds the same way
  (`tests/test_torch_distributed.py` pins the port's side);
* a world of one rank (`train_distributed`, gloo) is anakin, bitwise:
  the same seed, and a gradient sync over one rank changes no bit;
* the launcher's ``--runner sharded`` with 2 executors on the CPU.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.core.system import make_anakin, train_distributed  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.launch import train_marl  # noqa: E402
from repro_torch.systems import registry  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_distributed import JOIN_TIMEOUT_S, MADQN_SMOKE, PPO_SMOKE, WORLD  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_reference_per_device_init_differs_too():
    """The behaviour the runner reproduces: the reference's init splits the key per device."""
    from repro.core.system import init_system_state
    from repro.envs import make_env as jax_make_env
    from repro.systems import registry as jreg

    jsys = jreg.make_system("madqn", jax_make_env("matrix_game"), **MADQN_SMOKE)
    dev_keys = jax.random.split(jax.random.key(0), WORLD)
    params = [jax.jit(lambda k: init_system_state(jsys, k, 2).train.params)(k)
              for k in dev_keys]
    leaves = [jax.tree_util.tree_leaves(p) for p in params]
    gap = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(*leaves))
    assert gap > 0.1


def test_world_of_one_is_anakin_bitwise():
    kw = dict(PPO_SMOKE)
    env = make_env("matrix_game")
    system_fn = functools.partial(registry.make_system, "ippo", env, distributed_axis="data",
                                  **kw)
    params, metrics = train_distributed(system_fn, 7, 16, 4, 1, backend="gloo", device="cpu",
                                        timeout_s=JOIN_TIMEOUT_S)
    st, m = make_anakin(registry.make_system("ippo", env, **kw), 16, 4, device="cpu")(7)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(params),
                                                 tree_leaves(st.train.params), strict=True))
    assert float(metrics["reward"][0]) == float(m["reward"].mean())


def test_launcher_sharded_runner_on_the_cpu(capsys):
    out = train_marl.main(["--system", "vdn", "--env", "matrix_game", "--runner", "sharded",
                           "--num-executors", "2", "--iterations", "32", "--num-envs", "4",
                           "--eval-every", "1", "--eval-episodes", "4", "--device", "cpu"])
    assert len(out["per_executor_reward"]) == 2 and len(out["per_executor_eval_return"]) == 2
    assert out["env_steps"] == 32 * 4 * 2
    printed = capsys.readouterr().out
    assert "per_executor_reward" in printed and "runner=sharded" in printed
