"""Feed-forward MAPPO's trainer update: the port against the JAX package.

One full ``update`` of mappo (the centralised critic reads the global
state) on lbf, whose state is the concatenation of the id-augmented
observations, and on matrix_game, from a rollout that a JAX Anakin run
stored, with the JAX row permutations injected: params, Adam moments and
the mean loss at 1e-5 (`tests/test_torch_ippo.py::check_update`).  Its
act steps are held in `tests/test_torch_ippo.py::test_act_step_matches`.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_ippo import check_update  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("env_name", ["lbf", "matrix_game"])
@pytest.mark.parametrize("num_minibatches", [1, 3])
def test_update_matches(env_name, num_minibatches, monkeypatch):
    check_update("mappo", env_name, num_minibatches, monkeypatch)
