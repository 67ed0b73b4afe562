"""`repro_torch.breakdown --runner async` on the CPU, where its counts and host times hold.

IPPO on matrix_game (a tick: a rollout of every actor, then its update)
and VDN on spread (a tick: 8 steps of every actor, then 8 rows through
the gated updates) with 2 actors: one tick warms up, the timed ticks split
into the actors, the queue and the learner, each phase is profiled and its
dispatched aten ops counted, and no device number is reported without a
CUDA device.
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


@pytest.mark.parametrize("system,env,sets,unroll", [
    ("ippo", "matrix_game", ["rollout_len=16", "hidden_sizes=(16,16)"], 16),
    ("vdn", "spread", ["min_replay=16", "batch_size=8", "buffer_capacity=256"], 8),
])
def test_async_breakdown_on_the_cpu(system, env, sets, unroll, monkeypatch, capsys):
    monkeypatch.setattr(breakdown, "ASYNC_TICKS", 2)
    args = ["--runner", "async", "--system", system, "--env", env, "--num-envs", "4",
            "--num-actors", "2", "--param-sync-every", "2", "--device", "cpu"]
    breakdown.main(args + [x for s in sets for x in ("--set", s)])
    out = json.loads(capsys.readouterr().out)
    assert (out["runner"], out["num_actors"], out["param_sync_every"]) == ("async", 2, 2)
    assert out["gpu"].startswith("not measured") and out["device_idle_share"] is None
    assert out["unroll_len"] == unroll and out["ticks"] == 2
    phases = ("actors", "queue", "learner")
    assert set(out["profiled"]) == set(phases)
    steady = out["steady"]
    assert steady["tick_s"] == pytest.approx(sum(steady[f"{p}_s_per_tick"] for p in phases))
    assert steady["env_steps_per_s"] == pytest.approx(4 * 2 * unroll / steady["tick_s"])
    # 1 warm-up + 2 timed + 1 profiled + 1 counted ticks, 2 chunks a tick, nothing dropped
    assert steady["dropped"] == 0 and steady["learner_updates"] > 0
    if system == "ippo":  # one update a chunk
        assert steady["learner_updates"] == 2 * 5
    ops = out["dispatched_ops"]
    assert ops["actors_tick"] > 0 and ops["queue_tick"] > 0 and ops["learner_tick"] > 0
