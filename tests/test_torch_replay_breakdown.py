"""`repro_torch.breakdown`'s replay mode on the CPU, where its counts and host times hold.

VDN on spread with 2 seed lanes fills the table to ``min_replay`` rows
(500 at the registry's defaults: 63 iterations of 8 envs), then times
and profiles whole iterations, acting steps and updates apart, counts
the aten ops one acting iteration and one update dispatch, and reports
no device number without a CUDA device.  rec-MADQN runs in replay mode
and DIAL in rollout mode, each with config fields set by ``--set``.
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


@pytest.mark.parametrize("system,env,sets,mode", [
    # rec-MADQN's sequence table in replay mode: the linear core unless set otherwise
    ("rec_madqn", "spread", [], "replay"),
    ("rec_madqn", "speaker_listener", ["recurrent_core=gru"], "replay"),
    # DIAL's fused re-run in rollout mode: one rollout is the env's horizon
    ("dial", "switch_game", ["use_comm=False", "recurrent_core=linear"], "rollout"),
])
def test_breakdown_takes_the_matrix_paths_and_config_fields(system, env, sets, mode,
                                                            monkeypatch, capsys):
    monkeypatch.setattr(breakdown, "REPLAY_ITERATIONS", 2)
    built = []
    make_pair = breakdown.make_pair
    monkeypatch.setattr(breakdown, "make_pair",
                        lambda *a, **kw: built.append(kw) or make_pair(*a, **kw))
    args = ["--system", system, "--env", env, "--num-envs", "4", "--device", "cpu"]
    breakdown.main(args + [x for s in sets for x in ("--set", s)])
    out = json.loads(capsys.readouterr().out)
    assert out["dispatched_ops"]["update"] > 0
    if mode == "replay":
        assert out["iterations"] == 2 and out["fill_iterations"] >= 1
        assert built == [{"recurrent_core": "gru" if sets else "linear"}]
    else:
        assert out["rollout_len"] == 6  # switch_game's horizon for 3 prisoners
        assert built == [{"use_comm": False, "recurrent_core": "linear"}]
