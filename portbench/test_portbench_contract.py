"""CPU tests of the benchmark's files: names, lookups by name, imports and its own counts."""
from __future__ import annotations

import ast
import json
import pathlib
import re
import shutil

import pytest

from portbench import counts, harness, trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]
    for cell in BENCH["workloads"]:
        yield cell["config"]
        yield cell["traffic"]
    for cfg in BENCH["configs"]:
        yield from cfg["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_portbench_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_portbench_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        keys |= {"bound"}
    else:
        keys |= {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200
    assert set(metric) - {"workloads"} == keys


def test_portbench_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for path in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", path) and not path.endswith("_torch")
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    for cell in BENCH["workloads"]:
        assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
        e2e = harness.end_to_end_of(BENCH, cell)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.per_layer_of(BENCH, cell)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for cfg in BENCH["configs"]:
        assert cfg["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert any(c["config"] == cfg["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_portbench_cell_files_found_by_name(cell):
    cfg = harness.config_of(BENCH, cell, ROOT)
    assert cfg["name"] == cell["config"]
    traffic = harness.traffic_of(cell)
    assert harness.driver(traffic["driver"]).run
    assert harness.limits_of(cell)
    for metric in harness.per_layer_of(BENCH, cell):
        assert callable(harness.reader(metric["name"]).read)


def test_portbench_cell_added_by_files_alone(tmp_path):
    """A new cell, configuration, traffic mix, limits and metric are found with no code edit."""
    here = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (here / "configs" / "other.json").write_text(json.dumps({"name": "other", "hidden_size": 8}))
    (here / "traffic" / "other-mix.json").write_text(json.dumps({"driver": "lm_prefill"}))
    (here / "limits" / "other-cell.json").write_text(json.dumps({"token_gap": 1.0}))
    (here / "metrics" / "other_share.prefill.py").write_text(
        "def read(trace, window):\n    return 42.0\n")
    bench["configs"].append({"name": "other", "source": "https://example.org/other",
                             "file": "portbench/configs/other.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "other-cell", "config": "other",
                               "traffic": "other-mix", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "prefill_tokens_per_s":
            m["workloads"].append("other-cell")
    bench["per_layer"].append({"name": "other_share.prefill", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "kernels",
                               "moves": "prefill_tokens_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = harness.load_benchmark(tmp_path)
    cell = harness.find_cell(loaded, "other-cell")
    assert harness.config_of(loaded, cell, tmp_path)["hidden_size"] == 8
    assert harness.traffic_of(cell, here)["driver"] == "lm_prefill"
    assert harness.limits_of(cell, here) == {"token_gap": 1.0}
    names = [m["name"] for m in harness.per_layer_of(loaded, cell)]
    assert names == ["other_share.prefill"]
    assert harness.reader("other_share.prefill", here).read(None, {}) == 42.0
    assert [m["name"] for m in harness.end_to_end_of(loaded, cell)] == [
        "prefill_tokens_per_s", "setup_s"]
    # the metric without a ``workloads`` key reaches every cell that reports what it moves
    prefill = harness.find_cell(loaded, "fm7b-prefill-mixed")
    assert "other_share.prefill" in [m["name"] for m in harness.per_layer_of(loaded, prefill)]


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            found.add(node.module.split(".")[0])
    return found


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_portbench_imports_no_jax(path):
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "repro"}, found
    if "reference" in path.parts:
        assert found <= {"__future__", "dataclasses", "math", "torch"}, found


def test_portbench_forbidden_modules_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.sub", "jaxlib.xla", "repro_torch"]) == ["jaxlib",
                                                                                       "repro"]


def test_portbench_bounds_pinned():
    """The hand-worked bounds: the scan (4, 2048, 8192, 16) 256.77 us, its backward 513.54 us,
    fused_xent (16,384, 2,048, 92,544) 6.280 ms."""
    assert counts.selective_scan_bound_s(4, 2048, 8192, 16) * 1e6 == pytest.approx(256.77,
                                                                                    abs=0.01)
    assert counts.selective_scan_bwd_bound_s(4, 2048, 8192, 16) * 1e6 == pytest.approx(
        513.54, abs=0.01)
    assert counts.fused_xent_bound_s(16384, 2048, 92544) * 1e3 == pytest.approx(6.280, abs=5e-4)


def test_portbench_model_flops():
    cfg = json.loads((ROOT / "portbench/configs/mamba1-fm7b-l32.json").read_text())
    layer = 4096 * 16384 + 8192 * 4 + 8192 * 288 + 256 * 8192 + 8192 * 16 + 8192 + 8192 * 4096
    assert counts.mamba1_layer_params(cfg) == layer
    assert counts.mamba1_train_flops_per_position(cfg) == 6.0 * (32 * layer + 4096 * 65024)
    assert counts.mamba1_prefill_flops(cfg, 4, 100) == (2.0 * 32 * layer * 400
                                                        + 2.0 * 4096 * 65024 * 4)
    # one IPPO cycle at 1 lane, 1 env, 4 steps, 1 epoch of 1 minibatch, 1 agent:
    pa, pc = 14 * 64 + 64 * 64 + 64 * 5, 14 * 64 + 64 * 64 + 64
    assert counts.ppo_cycle_flops(14, (64, 64), 5, 1, 1, 1, 4, 1, 1) == (
        4 * 2 * (pa + pc) + 2 * pc + 4 * 6 * (pa + pc))


def test_portbench_trace_union_and_gaps():
    import numpy as np

    busy, gaps = trace._union_length(np.array([[5.0, 7.0], [0.0, 2.0], [1.0, 3.0], [6.0, 6.5]]))
    assert busy == 5.0
    assert gaps.tolist() == [[3.0, 5.0]]
    t = trace.Trace(window_s=1.0, busy_s=0.5, host_launches=10, device_ops=[], idle_gaps=[],
                    kernels={"void selective_scan_kernel<bf16>": [4, 0.2],
                             "void selective_scan_bwd_sweep<bf16>": [2, 0.1]})
    assert t.kernel("selective_scan", without=("_bwd",)) == (4, 0.2)
    assert t.kernel("selective_scan_bwd") == (2, 0.1)


def test_portbench_refuses_without_cuda(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from portbench import run

    assert run.main(["--workload", "fm7b-train-4x2048", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
