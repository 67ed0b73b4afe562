"""The port's throughput benchmark and artifact schema against the JAX package's.

* schema: `repro_torch.bench.schema` imports nothing but the standard
  library; the reference's drift cases (tests/test_bench.py: speed, serve
  and eval documents, missing provenance, the full-matrix pin on recurrent
  rows, the serve slice's slot counts) give the port's checkers the same
  problems as `repro.bench.schema`'s on the same mutated documents, but
  for the provenance key (``torch_version`` for ``jax_version``); the
  committed JAX ``BENCH_speed.json`` fails the port's check on
  ``torch_version`` alone; a GPU document must name the card and its
  power limit; the coverage pins equal the reference's and track the
  port's live registries;
* throughput: `run_bench` (every `bench_cell` rung) for ippo and rec_ippo
  on matrix_game at 2 envs x 32 iterations x 2 seeds on the CPU writes a
  document that passes `check_speed_schema` (and the reference's checker
  but for its provenance key), with ``fused_recurrent`` on rec_ippo only,
  ``async_actors`` at 1/2/4 and a positive ``shard_map`` rung from one
  gloo rank; `to_markdown`'s table rows equal the reference's for the
  same document; the serial and lanes sides of the seed rung end at the
  same params (float32 sum order).
"""
import copy
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.bench import schema as jschema  # noqa: E402
from repro.bench import throughput as jthroughput  # noqa: E402
from repro.envs import REGISTRY as JAX_ENVS  # noqa: E402
from repro.systems.registry import REGISTRY as JAX_SYSTEMS  # noqa: E402
from repro.systems.registry import compatibility as jax_compatibility  # noqa: E402
from repro_torch.bench import schema as tschema  # noqa: E402
from repro_torch.bench import throughput as tput  # noqa: E402
from repro_torch.envs import REGISTRY as PORT_ENVS  # noqa: E402
from repro_torch.systems import registry  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load(name):
    with open(REPO / name) as f:
        return json.load(f)


def _as_port(doc):
    """A JAX artifact with the port's provenance key in place of ``jax_version``."""
    doc = copy.deepcopy(doc)
    prov = doc.get("provenance")
    if isinstance(prov, dict) and "jax_version" in prov:
        prov["torch_version"] = prov.pop("jax_version")
    return doc


# ------------------------------------------------------------------ schema


def test_schema_loads_without_torch_or_numpy():
    path = str(REPO / "src" / "repro_torch" / "bench" / "schema.py")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('s', {path!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'repro', 'repro_torch')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_committed_jax_speed_doc_fails_only_on_torch_version():
    doc = _load("BENCH_speed.json")
    want = ["provenance.torch_version must be a non-empty string"]
    assert tschema.check_provenance(doc) == want
    assert tschema.check_speed_schema(doc) == want
    assert tschema.check_speed_schema(_as_port(doc)) == []


def _drop_anakin_and_num_seeds(doc):
    cell = next(c for c in doc["cells"] if c["compatible"])
    del cell["runners"]["anakin"]["steps_per_sec"]
    doc["config"].pop("num_seeds")


def _serve_drift(doc):
    doc["cells"][0]["latency"]["p99_ms"] = 0.5 * doc["cells"][0]["latency"]["p50_ms"]
    del doc["cells"][1]["decisions_per_sec"]
    doc["config"].pop("arrival_rate")


def _eval_drift(doc):
    sys_name = next(iter(doc["systems"]))
    cell = next(c for c in doc["systems"][sys_name]["envs"].values() if c.get("compatible"))
    cell["returns"] = cell["returns"][:-1] + [cell["returns"][-1][:-1]]
    del cell["aggregates"]["iqm_ci95"]


def _drop_rec_ippo_cells(doc):
    doc["cells"] = [c for c in doc["cells"] if c["system"] != "rec_ippo"]


def _drop_rec_ippo_system(doc):
    del doc["systems"]["rec_ippo"]


def _one_slot_count(doc):
    slots = sorted({c["max_slots"] for c in doc["cells"]})
    doc["cells"] = [c for c in doc["cells"] if c["max_slots"] == slots[0]]


def _gut_version(doc):
    key = "torch_version" if "torch_version" in doc["provenance"] else "jax_version"
    doc["provenance"][key] = ""


# (artifact, checker, mutation, a word every problem list must carry)
DRIFT = {
    "speed": ("BENCH_speed.json", "check_speed_schema", _drop_anakin_and_num_seeds,
              ["anakin", "num_seeds"]),
    "serve": ("BENCH_serve.json", "check_serve_schema", _serve_drift,
              ["p99", "decisions_per_sec", "arrival_rate"]),
    "eval": ("BENCH_eval.json", "check_eval_schema", _eval_drift, ["returns", "iqm_ci95"]),
    "speed_no_provenance": ("BENCH_speed.json", "check_speed_schema",
                            lambda d: d.pop("provenance"), ["provenance"]),
    "serve_no_provenance": ("BENCH_serve.json", "check_serve_schema",
                            lambda d: d.pop("provenance"), ["provenance"]),
    "eval_gutted_version": ("BENCH_eval.json", "check_eval_schema", _gut_version, ["version"]),
    "speed_full_matrix_rec_rows": ("BENCH_speed.json", "check_speed_full_matrix",
                                   _drop_rec_ippo_cells, ["rec_ippo"]),
    "eval_full_matrix_rec_rows": ("BENCH_eval.json", "check_eval_full_matrix",
                                  _drop_rec_ippo_system, ["rec_ippo"]),
    "serve_slice_slot_counts": ("BENCH_serve.json", "check_serve_slice", _one_slot_count,
                                ["slot"]),
    "speed_full_matrix_intact": ("BENCH_speed.json", "check_speed_full_matrix",
                                 lambda d: None, []),
    "eval_full_matrix_intact": ("BENCH_eval.json", "check_eval_full_matrix",
                                lambda d: None, []),
    "serve_slice_intact": ("BENCH_serve.json", "check_serve_slice", lambda d: None, []),
}


@pytest.mark.parametrize("case", sorted(DRIFT))
def test_port_checkers_find_the_reference_problems(case):
    name, checker, mutate, words = DRIFT[case]
    jax_doc = _load(name)
    port_doc = _as_port(jax_doc)
    mutate(jax_doc)
    mutate(port_doc)
    want = [e.replace("jax_version", "torch_version")
            for e in getattr(jschema, checker)(jax_doc)]
    got = getattr(tschema, checker)(port_doc)
    assert got == want
    for word in words:
        assert any(word in e for e in got), (word, got)
    assert bool(got) == bool(words)


def test_validate_path_dispatches_as_the_reference(tmp_path):
    for name in ("BENCH_speed.json", "BENCH_eval.json", "BENCH_serve.json"):
        path = tmp_path / name
        path.write_text(json.dumps(_as_port(_load(name))))
        assert tschema.validate_path(str(path)) == []
        assert tschema.validate_path(str(path), full=True) == []
    path = tmp_path / "other.json"
    path.write_text("{}")
    assert tschema.validate_path(str(path)) == [
        e.replace("jax_version", "torch_version") for e in jschema.validate_path(str(path))]


def test_gpu_documents_name_the_card_and_its_power_limit():
    doc = _as_port(_load("BENCH_speed.json"))
    doc["provenance"].update(backend="cuda", gpu="NVIDIA H100 80GB HBM3", power_limit="700.00 W")
    assert tschema.check_provenance(doc) == []
    doc["provenance"].update(gpu=None, power_limit="")
    assert tschema.check_provenance(doc) == [
        "provenance.gpu must be a non-empty string on a GPU",
        "provenance.power_limit must be a non-empty string on a GPU",
    ]
    doc["provenance"]["backend"] = "cpu"  # the CPU names no card
    assert tschema.check_provenance(doc) == []


def test_schema_coverage_pins_track_the_live_registries():
    for pin in ("FULL_MATRIX_SYSTEMS", "FULL_MATRIX_ENVS", "SPEED_SLICE_SYSTEMS",
                "ASYNC_ACTOR_COUNTS", "MIN_ASYNC_MONOTONIC_CELLS", "FUSED_RECURRENT_SYSTEM",
                "FUSED_RECURRENT_ENVS", "SERVE_SLICE_SYSTEMS", "MIN_SERVE_SLOT_COUNTS"):
        assert getattr(tschema, pin) == getattr(jschema, pin), pin
    assert list(tschema.FULL_MATRIX_SYSTEMS) == sorted(registry.REGISTRY) == sorted(JAX_SYSTEMS)
    assert list(tschema.FULL_MATRIX_ENVS) == sorted(PORT_ENVS) == sorted(JAX_ENVS)
    assert set(tschema.SPEED_SLICE_SYSTEMS) <= set(registry.REGISTRY)
    assert set(tschema.SERVE_SLICE_SYSTEMS) <= set(registry.REGISTRY)
    assert any(s.startswith("rec_") for s in tschema.SERVE_SLICE_SYSTEMS)
    assert any(not s.startswith("rec_") for s in tschema.SERVE_SLICE_SYSTEMS)


# -------------------------------------------------------------- throughput


def _table_rows(markdown):
    """The data rows of a throughput table (after its header and separator)."""
    lines = markdown.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("|---")) + 1
    return lines[start:]


# the cells' operating point: the smoke rollout (32 steps, so the async
# rung's unroll divides 32 iterations) with one minibatch of a small net
TINY = dict(hidden_sizes=(16,), rollout_len=32, epochs=1, num_minibatches=1)


@pytest.fixture(scope="module")
def speed_doc(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench") / "BENCH_speed.json"
    doc = tput.run_bench(["ippo", "rec_ippo"], ["matrix_game"], iterations=32, num_envs=2,
                         num_seeds=2, loop_episodes=1, out_path=str(out),
                         system_overrides={"ippo": TINY, "rec_ippo": TINY}, device="cpu")
    return out, doc


def test_bench_cells_pass_the_schema(speed_doc):
    out, doc = speed_doc
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    assert tschema.check_speed_schema(doc) == []
    assert tschema.validate_path(str(out)) == []
    # the reference's checker reads the port's document but for its provenance key
    assert jschema.check_speed_schema(doc) == ["provenance.jax_version must be a non-empty string"]
    assert doc["framework"] == "torch" and doc["provenance"]["backend"] == "cpu"
    assert doc["config"] == {"iterations": 32, "num_envs": 2, "num_seeds": 2, "loop_episodes": 1,
                             "backend": "cpu", "num_devices": 1}
    cells = {c["system"]: c for c in doc["cells"]}
    assert list(cells) == ["ippo", "rec_ippo"]
    assert "fused_recurrent" in cells["rec_ippo"] and "fused_recurrent" not in cells["ippo"]
    fr = cells["rec_ippo"]["fused_recurrent"]
    assert (fr["core"], fr["reference_core"]) == ("linear", "gru") and fr["speedup"] > 0
    for cell in cells.values():
        assert cell["config_overrides"] == dict(TINY, hidden_sizes=[16])
        runners = cell["runners"]
        assert runners["anakin"]["env_steps"] == 32 * 2
        assert len(runners["anakin"]["repeat_seconds"]) == 3
        assert runners["anakin"]["wall_seconds"] == min(runners["anakin"]["repeat_seconds"])
        sharded = runners["shard_map"]
        assert (sharded["backend"], sharded["num_devices"]) == ("gloo", 1)
        assert sharded["steps_per_sec"] > 0 and len(sharded["rank_wall_seconds"]) == 1
        assert sharded["call_wall_seconds"] > sharded["wall_seconds"]  # spawning included
        assert runners["python_loop"]["env_steps"] == cell["horizon"]  # one episode
        sv = cell["seed_vectorization"]
        assert sv["num_seeds"] == 2 and len(sv["lanes_repeat_seconds"]) == 3
        aa = cell["async_actors"]
        assert aa["actor_counts"] == [1, 2, 4] and aa["use_vtrace"] is True
        assert aa["unroll_len"] == 32  # the smoke rollout
        assert [row["env_steps"] for row in aa["cells"]] == [32 * 2 * a for a in (1, 2, 4)]


def test_markdown_rows_equal_the_reference(speed_doc):
    _, doc = speed_doc
    doc = copy.deepcopy(doc)
    incompatible = tput.bench_cell("maddpg", "matrix_game", 32, 2, 2, 1, device="cpu")
    assert incompatible == {"system": "maddpg", "env": "matrix_game", "compatible": False,
                            "reason": jax_compatibility("maddpg", "matrix_game")}
    doc["cells"].append(incompatible)
    rows = _table_rows(tput.to_markdown(doc))
    assert len(rows) == 3
    assert rows == _table_rows(jthroughput.to_markdown(doc))


def test_seed_sides_end_at_the_same_params():
    _, system = registry.make_pair("ippo", "matrix_game", **registry.smoke_overrides("ippo"))
    serial, lanes = tput._seed_sides(system, 2, 32, 2, CPU)
    singles, batched = serial(), lanes()
    assert batched.steps.tolist() == [1, 1]  # one update a lane
    for s, one in enumerate(singles):
        for x, y in zip(tree_leaves(batched.params), tree_leaves(one.params), strict=True):
            np.testing.assert_allclose(x[s].numpy(), y.numpy(), atol=1e-5, rtol=1e-5)
