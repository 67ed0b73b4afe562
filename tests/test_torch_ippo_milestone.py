"""The reference's IPPO learning milestone, run by the port on the CPU.

`tests/test_onpolicy.py`'s milestone system (matrix_game, horizon 10;
rollout 32, 4 epochs x 2 minibatches, entropy 0.02, lr 1e-3; 150 updates
x 16 envs): the last 15 updates' mean reward must end within 10% of the
recorded 4.994, with at least half the recorded improvement over the
first 15 (2.281).  The draws are the port's own, so the curve is not the
reference's; the milestones are.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import train_anakin  # noqa: E402
from repro_torch.envs import MatrixGame  # noqa: E402
from repro_torch.systems import PPOConfig, make_ippo  # noqa: E402

SEED_IPPO_FIRST15 = 2.281  # tests/test_onpolicy.py:18-19
SEED_IPPO_LAST15 = 4.994


@pytest.fixture
def one_thread():
    """Small ops run fastest on one thread: 4,800 iterations of them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_ippo_meets_the_reference_milestones_on_matrix_game(one_thread):
    system = make_ippo(
        MatrixGame(horizon=10),
        PPOConfig(rollout_len=32, epochs=4, num_minibatches=2, entropy_coef=0.02,
                  learning_rate=1e-3),
    )
    _, metrics = train_anakin(system, 0, 150 * 32, 16, device="cpu")
    r = metrics["reward"].reshape(150, 32).mean(-1)
    late = float(r[-15:].mean())
    improvement = late - float(r[:15].mean())
    assert abs(late - SEED_IPPO_LAST15) < 0.1 * abs(SEED_IPPO_LAST15), late
    assert improvement > 0.5 * (SEED_IPPO_LAST15 - SEED_IPPO_FIRST15), improvement
