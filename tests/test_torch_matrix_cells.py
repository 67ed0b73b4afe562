"""The port's whole support matrix: 13 systems x 7 envs, against the reference's registry.

* `compatibility` agrees with ``repro.systems.registry.compatibility``
  word for word on all 91 (system, env) cells, with and without the
  continuous mode asked for;
* each of the 77 runnable cells builds through `make_pair` and runs a
  few Anakin iterations at 2 envs on the CPU, at a config small enough
  that its trainer updates at least once, with an interleaved greedy
  evaluation: losses, rewards and returns finite, the update count what
  the config's dataset gives.  The cells split by system between this
  file and `tests/test_torch_matrix_cells_more.py`;
* the MARL launcher takes every system and env by name, and trains RIAL
  on switch_game with seed lanes and interleaved evaluation on the CPU.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro.envs import REGISTRY as JAX_ENVS  # noqa: E402
from repro.systems import registry as jreg  # noqa: E402
from repro_torch.core import train_anakin  # noqa: E402
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


SYSTEMS = sorted(jreg.REGISTRY)
ENVS = sorted(JAX_ENVS)
ITERATIONS, NUM_ENVS = 8, 2
# per config class: small enough that the dataset is ready within ITERATIONS
SMALL = {
    "PPOConfig": dict(rollout_len=4, hidden_sizes=(8, 8), epochs=1, num_minibatches=1),
    "OffPolicyConfig": dict(min_replay=4, batch_size=4, buffer_capacity=32, hidden_sizes=(8, 8)),
    "MaddpgConfig": dict(min_replay=4, batch_size=4, buffer_capacity=32, hidden_sizes=(8, 8)),
    "RecMadqnConfig": dict(seq_len=2, burn_in=1, min_windows=2, batch_size=2,
                           buffer_capacity=16, hidden_sizes=(8,)),
    "DialConfig": dict(rollout_len=4, hidden_dim=8),
}
RUNNABLE = [(s, e) for s in SYSTEMS for e in ENVS if jreg.compatibility(s, e) is None]
FIRST = ("dial", "ippo", "mad4pg", "maddpg", "madqn", "madqn-fp", "mappo")


def _updates(config_cls: str) -> int:
    """The updates ITERATIONS iterations of NUM_ENVS envs run at the SMALL config."""
    cfg = SMALL[config_cls]
    if "rollout_len" in cfg:
        return ITERATIONS // cfg["rollout_len"]
    if "min_windows" in cfg:  # the first flush comes with the window's last step
        return ITERATIONS - (cfg["seq_len"] + cfg["burn_in"]) + 1
    return ITERATIONS - math.ceil(cfg["min_replay"] / NUM_ENVS) + 1


def run_cell(system_name, env_name):
    """Build the cell through `make_pair` and run a short Anakin program with an evaluation."""
    config_cls = registry.REGISTRY[system_name].config_cls.__name__
    env, system = registry.make_pair(system_name, env_name, **SMALL[config_cls])
    assert system.env is env and system.spec == env.spec()
    st, metrics, evals = train_anakin(system, 0, ITERATIONS, NUM_ENVS, eval_every=ITERATIONS,
                                      eval_episodes=2, device="cpu")
    updates = _updates(config_cls)
    steps = st.train.steps
    assert (steps if isinstance(steps, int) else int(steps)) == updates >= 1
    loss = "critic_loss" if system_name in ("maddpg", "mad4pg") else "loss"
    assert metrics[loss].shape == (updates,)
    assert metrics["reward"].shape == (ITERATIONS,)
    assert evals.episode_return.shape == (1, 2)
    for x in [*metrics.values(), evals.episode_return, *tree_leaves(st.train.params)]:
        assert bool(torch.isfinite(x).all())


@pytest.mark.parametrize("system_name", SYSTEMS)
@pytest.mark.parametrize("env_name", ENVS)
def test_compatibility_matches_the_reference(system_name, env_name):
    assert sorted(registry.REGISTRY) == SYSTEMS and sorted(registry.ENV_REGISTRY) == ENVS
    for kw in (None, {"continuous": True}):
        assert registry.compatibility(system_name, env_name, kw) == jreg.compatibility(
            system_name, env_name, kw)


@pytest.mark.parametrize("system_name,env_name",
                         [c for c in RUNNABLE if c[0] in FIRST])
def test_runnable_cell_builds_and_trains(system_name, env_name):
    run_cell(system_name, env_name)


def test_the_matrix_has_77_runnable_cells():
    assert len(SYSTEMS) * len(ENVS) == 91 and len(RUNNABLE) == 77
    refused = {c for s in SYSTEMS for e in ENVS if (c := (s, e)) not in RUNNABLE}
    assert {e for s, e in refused if s in ("dial", "rial")} == {"speaker_listener"}
    assert {s for s, _ in refused} == {"dial", "rial", "maddpg", "mad4pg"}


def test_the_launcher_takes_every_system_and_env(capsys):
    from repro_torch.launch import train_marl

    for name in SYSTEMS:
        assert train_marl.parse_args(["--system", name]).system == name
    for env in ENVS:
        assert train_marl.parse_args(["--env", env]).env == env
    out = train_marl.main(["--system", "rial", "--env", "switch_game", "--iterations", "12",
                           "--num-envs", "2", "--num-seeds", "2", "--eval-every", "6",
                           "--eval-episodes", "2", "--device", "cpu"])
    assert out["env_steps"] == 12 * 2 * 2 and math.isfinite(out["eval_return"])
    assert "rial on switch_game" in capsys.readouterr().out
