"""One trainer ``update`` of VDN and QMIX: the port against the JAX package.

The mixed-TD cases of `tests/test_torch_replay_update.py::check_update`:
for both systems x matrix_game, spread and lbf x shared weights on and
off, the loss, gradients, params, optimizer state, targets and update
count after one update from the same state, the JAX sample indices
injected, at that file's tolerances.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_replay_systems import ENVS  # noqa: E402
from test_torch_replay_update import check_update  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("env_name", ENVS)
@pytest.mark.parametrize("name", ["vdn", "qmix"])
@pytest.mark.parametrize("shared_weights", [True, False])
def test_update_matches(name, env_name, shared_weights, monkeypatch):
    check_update(name, env_name, shared_weights, monkeypatch)
