"""QMIX's run of the reference's value-system milestone (`tests/test_system.py:23-32`).

The QMIX case of `tests/test_torch_replay_milestone.py`, in a file of its
own so that each file stays short on one test worker.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_replay_milestone import check_value_system_learns_matrix_game  # noqa: E402


@pytest.fixture
def one_thread():
    """Small ops run fastest on one thread: 3,000 iterations of them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["qmix"])
def test_value_system_learns_matrix_game(name, one_thread):
    check_value_system_learns_matrix_game(name)
