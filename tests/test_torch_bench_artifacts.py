"""The port's launchers write artifacts that its schema accepts.

* `bench_marl` on the CPU writes ``BENCH_speed.json`` and its markdown
  (by default under ``results/port/``, never the root's JAX artifact),
  and ``scripts/check_port_bench_schema.py`` (run without torch) passes
  the JSON and refuses the root's JAX ``BENCH_speed.json`` on its
  provenance; without ``--device`` and without CUDA it raises;
* the other launchers' documents pass
  `repro_torch.bench.schema.validate_path`: the `eval_marl` sweep
  (BENCH_eval), `serve_marl` serving a checkpoint saved in ``tmp_path``
  (BENCH_serve) and the ``run.json`` record of `train_marl --log-dir
  --profile`.
"""
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench.schema import validate_path  # noqa: E402
from repro_torch.launch import bench_marl, eval_marl, serve_marl, train_marl  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"
SCRIPT = REPO / "scripts" / "check_port_bench_schema.py"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread runs them fastest and leaves the
    other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _check_script(*paths):
    """The schema script's exit code and output, run without torch on its path."""
    out = subprocess.run([sys.executable, "-S", str(SCRIPT), *map(str, paths)],
                         capture_output=True, text=True)
    return out.returncode, out.stdout


def test_bench_marl_writes_a_valid_speed_artifact(tmp_path):
    out = tmp_path / "port" / "BENCH_speed.json"
    doc = bench_marl.main(["--systems", "vdn", "--envs", "matrix_game", "--iterations", "32",
                           "--num-envs", "2", "--num-seeds", "2", "--loop-episodes", "1",
                           "--out", str(out), "--device", CPU])
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    assert out.with_suffix(".md").read_text().startswith("# Training throughput")
    (cell,) = doc["cells"]
    assert (cell["system"], cell["compatible"]) == ("vdn", True)
    assert cell["async_actors"]["unroll_len"] == 8  # a replay system's chunk
    assert validate_path(str(out)) == []
    rc, stdout = _check_script(out)
    assert rc == 0 and "schema OK" in stdout
    rc, stdout = _check_script(REPO / "BENCH_speed.json")  # the JAX package's artifact
    assert rc == 1 and "provenance.torch_version must be a non-empty string" in stdout


def test_bench_marl_defaults_are_the_reference_but_for_out():
    args = bench_marl.parse_args([])
    assert args.systems == ["vdn", "ippo", "rec_ippo"]
    assert args.envs == ["matrix_game", "spread", "lbf"]
    assert (args.iterations, args.num_envs, args.num_seeds, args.loop_episodes) == (256, 4, 8, 3)
    assert args.out == "results/port/BENCH_speed.json" and args.device is None
    assert not hasattr(args, "defaults")  # the reference's flags: no operating-point switch


def test_run_bench_reaches_the_registry_defaults_through_system_overrides(
        monkeypatch, tmp_path):
    from repro_torch.bench import throughput

    seen = {}

    def cell(system_name, env_name, *args, system_overrides=None, device=None):
        seen[system_name] = system_overrides
        return {"system": system_name, "env": env_name, "compatible": False, "reason": "-"}

    monkeypatch.setattr(throughput, "bench_cell", cell)
    throughput.run_bench(["ippo", "vdn"], ["spread"], out_path=str(tmp_path / "d.json"),
                         system_overrides={"ippo": {}}, device=CPU)
    assert seen == {"ippo": {}, "vdn": None}  # {}: the registry's defaults; None: smoke
    bench_marl.main(["--systems", "ippo", "--envs", "spread", "--out", str(tmp_path / "s.json"),
                     "--device", CPU])
    assert seen["ippo"] is None  # the launcher benches at the smoke operating point


def test_bench_marl_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_marl.main(["--systems", "ippo", "--envs", "matrix_game"])


def test_the_other_launchers_documents_pass_the_schema(tmp_path):
    swept = tmp_path / "BENCH_eval.json"
    eval_marl.main(["--systems", "ippo", "maddpg", "--envs", "matrix_game", "--seeds", "0", "1",
                    "--eval-episodes", "2", "--num-envs", "2", "--out", str(swept),
                    "--device", CPU])
    ckpt = tmp_path / "ckpt" / "ippo"
    trained = train_marl.main([
        "--system", "ippo", "--env", "matrix_game", "--iterations", "16", "--num-envs", "2",
        "--set", "rollout_len=8", "--set", "hidden_sizes=(16,)", "--set", "epochs=1",
        "--log-dir", str(tmp_path / "runs"), "--run-id", "r", "--profile",
        "--save-checkpoint", str(ckpt), "--device", CPU,
    ])
    served = tmp_path / "BENCH_serve.json"
    serve_marl.main(["--checkpoints", str(ckpt), "--slots", "2", "--streams", "2",
                     "--episodes-per-stream", "1", "--out", str(served), "--device", CPU])
    record = pathlib.Path(trained["run_record"])
    assert json.loads(record.read_text())["profile"]["trace_dir"]
    for path in (swept, served, record):
        assert validate_path(str(path)) == [], path
    rc, stdout = _check_script(swept, served, record)
    assert rc == 0 and stdout.count("schema OK") == 3
