"""rec-MAPPO with the GRU core on spread: the port against the JAX package.

The checks of `tests/test_torch_rec_mappo.py` (one act step, one update
with one and two sequence minibatches, at 1e-5) for the reference's
default memory core.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_rec_mappo import check_act_step, check_update  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_act_step_matches():
    check_act_step("gru")


@pytest.mark.parametrize("num_minibatches", [1, 2])
def test_update_matches(num_minibatches, monkeypatch):
    check_update("gru", num_minibatches, monkeypatch)
