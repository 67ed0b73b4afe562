"""The reference's value-system learning milestone, run by the port on the CPU.

`tests/test_system.py:13-32`: FAST_CFG (replay 5,000, min_replay 100,
batch 32, eps decay 2,000 updates, target period 50, lr 1e-3) on
`MatrixGame(horizon=10)`, 3,000 Anakin iterations x 8 envs, seed 0: the
last 200 iterations' mean reward must beat the first 200's by 2 and
exceed 3 (random play averages ~ -3.4).  The draws are the port's own,
so the curve is not the reference's; the milestones are.  This file runs
MADQN and VDN; `tests/test_torch_replay_milestone_qmix.py` runs QMIX.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import train_anakin  # noqa: E402
from repro_torch.envs import MatrixGame  # noqa: E402
from repro_torch.systems import OffPolicyConfig, make_madqn, make_qmix, make_vdn  # noqa: E402

FAST_CFG = OffPolicyConfig(  # tests/test_system.py:13-20
    buffer_capacity=5_000,
    min_replay=100,
    batch_size=32,
    eps_decay_steps=2_000,
    target_update_period=50,
    learning_rate=1e-3,
)
MAKERS = {"madqn": make_madqn, "vdn": make_vdn, "qmix": make_qmix}


@pytest.fixture
def one_thread():
    """Small ops run fastest on one thread: 3,000 iterations of them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def check_value_system_learns_matrix_game(name):
    """All value-decomposition systems must beat random on the climbing game."""
    system = MAKERS[name](MatrixGame(horizon=10), FAST_CFG)
    st, metrics = train_anakin(system, 0, 3_000, 8, device="cpu")
    assert st.train.steps == 3_000 - 12  # an update every iteration from the 100th row
    r = metrics["reward"]
    early, late = float(r[:200].mean()), float(r[-200:].mean())
    assert late > early + 2.0, (early, late)
    assert late > 3.0, late


@pytest.mark.parametrize("name", ["madqn", "vdn"])
def test_value_system_learns_matrix_game(name, one_thread):
    check_value_system_learns_matrix_game(name)
