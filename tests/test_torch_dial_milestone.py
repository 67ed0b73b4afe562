"""The reference's DIAL and RIAL learning milestones, run by the port on the CPU.

`tests/test_marl_modules.py:98-109`: DIAL and RIAL at their default
configs on the 3-prisoner switch riddle, 16 envs, one episode a rollout
(the horizon, 6 steps) and one update a rollout.  DIAL over 60 updates
must not diverge (the last 15 updates' mean reward above the first 15's
less 0.05); RIAL over 120 updates must improve (the last 30 above the
first 30).  The draws are the port's own, so the curves are not the
reference's; the milestones are.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import train_anakin  # noqa: E402
from repro_torch.envs import SwitchGame  # noqa: E402
from repro_torch.systems.dial import DialConfig, make_dial  # noqa: E402


@pytest.fixture
def one_thread():
    """Small ops run fastest on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _per_update_rewards(protocol: str, num_updates: int):
    env = SwitchGame(num_agents=3)
    system = make_dial(env, DialConfig(protocol=protocol))
    state, metrics = train_anakin(system, 0, num_updates * env.horizon, 16, device="cpu")
    assert state.train.steps == num_updates
    return metrics["reward"].numpy().reshape(num_updates, env.horizon).mean(-1)


def test_dial_learns_on_switch_game_smoke(one_thread):
    r = _per_update_rewards("dial", 60)
    assert np.isfinite(r).all()
    assert r[-15:].mean() > r[:15].mean() - 0.05  # not diverging


def test_rial_protocol_learns(one_thread):
    r = _per_update_rewards("rial", 120)
    assert np.isfinite(r).all()
    assert r[-30:].mean() > r[:30].mean()
