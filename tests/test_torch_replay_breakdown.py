"""`repro_torch.breakdown`'s replay mode on the CPU, where its counts and host times hold.

VDN on spread with 2 seed lanes fills the table to ``min_replay`` rows
(500 at the registry's defaults: 63 iterations of 8 envs), then times
and profiles whole iterations, acting steps and updates apart, counts
the aten ops one acting iteration and one update dispatch, and reports
no device number without a CUDA device.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch import breakdown  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_replay_breakdown_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(breakdown, "REPLAY_ITERATIONS", 4)
    breakdown.main(["--system", "vdn", "--env", "spread", "--num-seeds", "2",
                    "--num-envs", "8", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert (out["system"], out["env"], out["num_seeds"]) == ("vdn", "spread", 2)
    assert out["gpu"].startswith("not measured") and out["device_idle_share"] is None
    ops = out["dispatched_ops"]
    assert ops["act_iteration"] > 0 and ops["update"] > ops["act_iteration"]
    assert set(out["profiled"]) == {"act", "update"}
    assert out["iterations"] == 4 and out["fill_iterations"] == 63
    steady = out["steady"]
    assert steady["env_steps_per_s"] == pytest.approx(2 * 8 * 4 / steady["iterations_s"])
    assert out["profiled"]["update"]["wall_ms_per_step"] > 0
