"""The runnable cells of the support matrix not in `tests/test_torch_matrix_cells.py`.

The same parametrised check, `test_torch_matrix_cells.run_cell`, over the
systems that file leaves out: qmix, rec_ippo, rec_madqn, rec_mappo, rial
and vdn on every env they run on.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_matrix_cells import FIRST, RUNNABLE, run_cell  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("system_name,env_name",
                         [c for c in RUNNABLE if c[0] not in FIRST])
def test_runnable_cell_builds_and_trains(system_name, env_name):
    run_cell(system_name, env_name)
