"""The port's evaluation sweep and its MARL launchers against the JAX package.

* a sweep over systems x envs that includes incompatible cells emits every
  cell; each incompatible cell carries `repro.systems.registry.
  compatibility`'s reason word for word, as the reference's sweep records
  it; a cell's aggregates (IQM and its CI among them) equal
  `repro.eval.stats.aggregate` on the same returns exactly;
* the three launchers run end to end at tiny sizes with ``--device cpu``
  into a temporary directory: `eval_marl`, `train_marl` with every
  observability flag and ``--save-checkpoint``, then `serve_marl` on that
  checkpoint, and `serve_marl`'s own train-then-serve; none writes at the
  repository root, and each raises without ``--device`` where there is no
  CUDA.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.eval.stats import aggregate as jax_aggregate  # noqa: E402
from repro.systems.registry import compatibility as jax_compatibility  # noqa: E402
from repro_torch.eval import run_sweep, to_markdown  # noqa: E402
from repro_torch.launch import eval_marl, serve_marl, train_marl  # noqa: E402

CPU = "cpu"
SYSTEMS = ["ippo", "maddpg", "dial"]
ENVS = ["matrix_game", "speaker_listener"]


def test_sweep_emits_every_cell_with_the_reference_reasons(tmp_path):
    out = tmp_path / "eval.json"
    results = run_sweep(SYSTEMS, ENVS, seeds=(0, 1), num_episodes=3, num_envs=2,
                        out_path=str(out), device=CPU)
    assert json.loads(out.read_text()) == json.loads(json.dumps(results))
    assert results["framework"] == "torch" and results["provenance"]["backend"] == "cpu"
    incompatible = 0
    for s in SYSTEMS:
        assert list(results["systems"][s]["envs"]) == ENVS
        for e in ENVS:
            cell = results["systems"][s]["envs"][e]
            reason = jax_compatibility(s, e)
            assert cell["compatible"] == (reason is None)
            if reason is not None:
                incompatible += 1
                assert cell == {"compatible": False, "reason": reason}
            else:
                team = np.asarray(cell["returns"])
                assert team.shape == (2, 3)
                assert cell["aggregates"] == jax_aggregate(team)
    assert incompatible == 3  # maddpg on discrete envs, dial on heterogeneous agents
    assert "--" in to_markdown(results)
    assert out.with_suffix(".md").read_text() == to_markdown(results)


def test_sweep_trains_seed_lanes_before_evaluating(tmp_path):
    results = run_sweep(["ippo"], ["matrix_game"], seeds=(3, 4), num_episodes=2, num_envs=2,
                        train_iterations=4, out_path=str(tmp_path / "e.json"), device=CPU)
    cell = results["systems"]["ippo"]["envs"]["matrix_game"]
    assert np.asarray(cell["returns"]).shape == (2, 2) and cell["steps_per_sec"] > 0


def test_eval_marl_launcher(tmp_path):
    out = tmp_path / "port" / "BENCH_eval.json"
    eval_marl.main(["--systems", "vdn", "maddpg", "--envs", "matrix_game", "--seeds", "0",
                    "--eval-episodes", "2", "--num-envs", "2", "--train-iterations", "2",
                    "--out", str(out), "--device", CPU])
    doc = json.loads(out.read_text())
    cells = doc["systems"]
    assert cells["maddpg"]["envs"]["matrix_game"] == {
        "compatible": False,
        "reason": "maddpg supports continuous action spaces; env has discrete actions",
    }
    assert cells["vdn"]["envs"]["matrix_game"]["compatible"]


def test_train_then_serve_launchers(tmp_path):
    """train_marl with every observability flag and --save-checkpoint, then serve_marl on it."""
    ckpt = tmp_path / "ckpt" / "rec_ippo"
    out = train_marl.main([
        "--system", "rec_ippo", "--env", "matrix_game", "--iterations", "16", "--num-envs", "4",
        "--num-seeds", "2", "--set", "recurrent_core=linear", "--set", "rollout_len=8",
        "--set", "hidden_sizes=(16,)", "--set", "epochs=1", "--set", "num_minibatches=2",
        "--log-every", "8", "--log-dir", str(tmp_path / "runs"),
        "--run-id", "rec", "--profile", "--save-checkpoint", str(ckpt), "--device", CPU,
    ])
    record = json.loads(pathlib.Path(out["run_record"]).read_text())
    assert "skipped" not in record["profile"]
    assert pathlib.Path(record["profile"]["trace_file"]).is_file()
    roofline = record["profile"]["roofline"]
    assert roofline["iterations"] == 8  # the first update ends the rollout
    # one update of 2 lanes (folded into one batch): a bootstrap unroll an
    # agent, then an actor and a critic unroll an agent in each of the 2
    # minibatches, forward and backward
    assert roofline["custom_ops"]["recurrent_scan"]["calls"] == 2 + 2 * (2 * 2) * 2
    meta = json.loads((ckpt / "policy.json").read_text())
    assert meta["num_seeds"] == 2 and meta["config_overrides"]["recurrent_core"] == "linear"

    served = serve_marl.main(["--checkpoints", str(ckpt), "--slots", "2", "--streams", "2",
                              "--episodes-per-stream", "2", "--out",
                              str(tmp_path / "serve.json"), "--device", CPU])
    (cell,) = served["cells"]
    assert (cell["system"], cell["max_slots"], cell["episodes"]) == ("rec_ippo", 2, 4)
    assert served["framework"] == "torch"
    assert (tmp_path / "serve.md").is_file()


def test_serve_marl_trains_then_serves(tmp_path):
    served = serve_marl.main(["--systems", "ippo", "--train-iterations", "32",
                              "--train-num-envs", "2", "--ckpt-dir", str(tmp_path / "ck"),
                              "--slots", "1", "3", "--streams", "2", "--episodes-per-stream",
                              "1", "--out", str(tmp_path / "s.json"), "--device", CPU])
    assert [c["max_slots"] for c in served["cells"]] == [1, 3]
    assert all(c["decisions"] == 2 * 10 for c in served["cells"])
    assert (tmp_path / "ck" / "ippo-matrix_game" / "policy.json").is_file()


def test_launchers_default_outside_the_root():
    assert serve_marl.parse_args([]).out == eval_marl.parse_args([]).out.replace("eval", "serve")
    for default in (serve_marl.parse_args([]).out, eval_marl.parse_args([]).out):
        assert default.startswith("results/port/")
    assert serve_marl.parse_args([]).ckpt_dir.startswith("results/")


@pytest.mark.parametrize("launcher,argv", [
    (train_marl, ["--system", "ippo", "--env", "matrix_game", "--iterations", "1"]),
    (serve_marl, ["--checkpoints", "nowhere"]),
    (eval_marl, ["--systems", "ippo", "--envs", "matrix_game"]),
], ids=["train_marl", "serve_marl", "eval_marl"])
def test_launchers_need_a_device_without_cuda(launcher, argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(argv)
