"""The port's paper-figure harness against the JAX package's ``benchmarks/``.

* each figure module of `repro_torch.benchmarks` keeps the reference's
  settings, read from the root's ``benchmarks/<name>.py`` by file path
  (the directory is no package): its module-level config equals the
  reference's field by field; the literal assignments of the reference
  (iteration counts as ``fast`` / full pairs, env counts, rollout
  lengths) appear in the port's module with the same values; the config
  and env constructors, the evaluator's episode and env counts and the
  literal loops (env counts, executor counts) are the same calls in the
  same order; the literal env / iteration counts passed to the runners
  are the same.  The distribution figure's reference runs its training
  from a code string in a subprocess, which is read the same way;
* `speedup.bench(fast=True, device="cpu")` runs and yields the
  reference's row names;
* ``run.py``'s ``MODULES`` is the reference's without ``roofline``.
"""
import ast
import dataclasses
import importlib.util
import math
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import run as port_run  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
FIGURES = ["speedup", "switch_game", "value_decomposition", "architectures", "distribution"]
# the constructors whose literal keyword arguments are a figure's settings
SETTINGS = {"OffPolicyConfig", "DialConfig", "MaddpgConfig", "PPOConfig", "Spread",
            "SwitchGame", "SmaxLite", "SpeakerListener", "evaluate"}
# the runners whose literal positional arguments after the first two are env
# and iteration counts
RUNNERS = {"train_anakin", "train_distributed", "measure_seed_vectorization"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread runs them fastest and leaves the
    other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reference_path(name):
    return REPO / "benchmarks" / f"{name}.py"


def _port_path(name):
    return REPO / "src" / "repro_torch" / "benchmarks" / f"{name}.py"


def _load_reference(name):
    spec = importlib.util.spec_from_file_location(f"reference_benchmarks_{name}",
                                                  _reference_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _literal(node):
    """A literal, ``A if fast else B`` of literals as ``{"fast": A, "full": B}``, or None."""
    if isinstance(node, ast.IfExp) and isinstance(node.test, ast.Name) and node.test.id == "fast":
        a, b = _literal(node.body), _literal(node.orelse)
        return None if a is None or b is None else {"fast": a, "full": b}
    try:
        return ast.literal_eval(node)
    except ValueError:
        return None


def _callee(call):
    f = call.func
    return f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None


def _trees(path):
    """A figure module's syntax tree, and the reference's training code held in a string."""
    tree = ast.parse(path.read_text())
    trees = [tree]
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "_CODE"):
            trees.append(ast.parse(node.value.value.format(iters=0)))
    return trees


def _settings(path) -> dict:
    """What a figure module fixes: literal assignments, setting calls, runner counts, loops."""
    assigned, calls, counts, loops = {}, [], set(), {}
    for i, tree in enumerate(_trees(path)):
        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                value = _literal(node.value)
                # the code string itself, and its iteration count's placeholder
                name = node.targets[0].id
                if value is not None and name != "_CODE" and not (i and name == "iters"):
                    assigned[name] = value
            elif isinstance(node, ast.Call) and _callee(node) in SETTINGS:
                kwargs = {k.arg: _literal(k.value) for k in node.keywords}
                calls.append((_callee(node), {k: v for k, v in kwargs.items() if v is not None}))
            elif isinstance(node, ast.Call) and _callee(node) in RUNNERS:
                counts.add(tuple(_literal(a) for a in node.args[2:] if _literal(a) is not None))
            elif isinstance(node, ast.For) and _literal(node.iter) is not None:
                loops[node.target.id] = _literal(node.iter)
    return {"assigned": assigned, "calls": sorted(calls, key=repr), "counts": counts,
            "loops": loops}


def _row_names(path, fast=True):
    """The row names a figure module emits, from its name strings and f-strings."""
    settings = _settings(path)
    value = lambda v: v["fast" if fast else "full"] if isinstance(v, dict) else v
    names = []
    tree = ast.parse(path.read_text())
    parts = {id(v) for n in ast.walk(tree) if isinstance(n, ast.JoinedStr) for v in n.values}
    strings = [n for n in ast.walk(tree)
               if isinstance(n, (ast.Constant, ast.JoinedStr)) and id(n) not in parts]
    for node in sorted(strings, key=lambda n: (n.lineno, n.col_offset)):
        if isinstance(node, ast.Constant):
            if isinstance(node.value, str) and node.value.startswith("speedup/"):
                names.append(node.value)
            continue
        head = node.values[0]
        if not (isinstance(head, ast.Constant) and head.value.startswith("speedup/")):
            continue
        (var,) = {v.value.id for v in node.values if isinstance(v, ast.FormattedValue)}
        for x in settings["loops"].get(var, [value(settings["assigned"].get(var))]):
            names.append("".join(str(x) if isinstance(v, ast.FormattedValue) else v.value
                                 for v in node.values))
    return names


@pytest.mark.parametrize("name", FIGURES)
def test_figure_keeps_the_reference_settings(name):
    ref, port = _settings(_reference_path(name)), _settings(_port_path(name))
    for var, value in ref["assigned"].items():
        assert port["assigned"].get(var) == value, (var, value, port["assigned"].get(var))
    assert port["calls"] == ref["calls"]
    assert port["counts"] == ref["counts"]
    assert port["loops"] == ref["loops"]
    assert ref["calls"] and ref["assigned"]  # the reader found the figure's settings


@pytest.mark.parametrize("name", ["speedup", "value_decomposition", "architectures"])
def test_figure_config_equals_the_reference(name):
    port = importlib.import_module(f"repro_torch.benchmarks.{name}")
    assert dataclasses.asdict(port.CFG) == dataclasses.asdict(_load_reference(name).CFG)


def test_run_modules_are_the_reference_without_roofline():
    tree = ast.parse(_reference_path("run").read_text())
    modules = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                   if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "MODULES")
    assert port_run.MODULES == [m for m in modules if m != "roofline"]
    assert sorted(port_run.MODULES) == sorted(FIGURES)


def test_speedup_runs_with_the_reference_row_names():
    from repro_torch.benchmarks import speedup

    rows = speedup.bench(fast=True, device="cpu")
    want = _row_names(_reference_path("speedup"))
    assert want == [  # the reader's names at --fast: 16 eval envs and 4 seeds
        "speedup/acme_python_loop", "speedup/anakin_jit_1env", "speedup/anakin_vmap_16env",
        "speedup/anakin_vmap_64env", "speedup/python_eval_loop", "speedup/fused_eval_16env",
        "speedup/seed_vmap_4seeds",
    ]
    assert [r[0] for r in rows] == want
    assert all(math.isfinite(us) and us > 0 for _, us, _ in rows)
    assert all("steps/s" in derived for _, _, derived in rows)


def test_harness_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_run.main(["--fast", "--only", "speedup"])
