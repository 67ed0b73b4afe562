"""The reference's six example scripts on the port (`repro_torch.examples`).

* each example's ``main`` runs at a small size on ``--device cpu`` and
  returns finite curves of the sizes it was given; `distributed_ippo`
  runs its executors as gloo ranks on the CPU and says so;
* `continuous_batching` runs at its own size, where its assertion (the
  engine's output for request 0 equals sequential prefill + decode)
  holds, and serves every request its 8 tokens;
* the flags the reference scripts take have the reference's defaults
  (read from ``examples/*.py`` by AST), and the size flags of the scripts
  that take none default to the reference's constants;
* without a GPU and without ``--device`` every example raises.

The learning assertions of quickstart and lm_train hold at the
reference's sizes only, where every size flag has its default; the small
runs here do not make them (and say so), and the card runs them at their
defaults.
"""
import ast
import importlib
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

EXAMPLES = ["quickstart", "distributed_ippo", "smax_vdn", "switch_game_dial",
            "continuous_batching", "lm_train"]
REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "examples"
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _example(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _finite(x):
    return bool(np.isfinite(np.asarray(x, dtype=np.float64)).all())


def test_quickstart_small():
    out = _example("quickstart").main(
        ["--iterations", "200", "--eval-every", "100", "--ippo-iterations", "64", *CPU])
    assert len(out["loop_returns"]) == 3 and out["reward"].shape == (200,)
    assert out["eval_returns"].shape == (2,) and out["ippo_reward"].shape == (64,)
    assert all(_finite(out[k]) for k in ("reward", "eval_returns", "ippo_reward"))


def test_distributed_ippo_small(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each spawned rank: one intra-op thread
    out = _example("distributed_ippo").main(
        ["--iterations", "64", "--executors", "2", "--executor-iterations", "64", *CPU])
    assert out["backend"] == "gloo" and out["per_executor_reward"].shape == (2,)
    assert _finite(out["reward"]) and _finite(out["per_executor_reward"])
    assert "(gloo, 2 CPU ranks)" in capsys.readouterr().out


def test_smax_vdn_small():
    out = _example("smax_vdn").main(["--iters", "80", *CPU])
    assert sorted(out) == ["VDN", "independent MADQN"]
    assert all(r.shape == (80,) and _finite(r) for r in out.values())


def test_switch_game_dial_small():
    out = _example("switch_game_dial").main(["--updates", "2", *CPU])
    assert sorted(out) == ["DIAL (learned channel)", "no communication"]
    assert all(_finite(list(r.values())) for r in out.values())


def test_lm_train_small():
    out = _example("lm_train").main(["--steps", "2", "--batch", "2", "--seq", "16", *CPU])
    assert len(out["losses"]) == 2 and _finite(out["losses"])
    # the plain versions run on the CPU: no kernel launches
    assert out["flash_launches"] == out["xent_launches"] == 0


def test_continuous_batching_parity_at_its_own_size():
    out = _example("continuous_batching").main(CPU)  # asserts engine == sequential
    assert sorted(out["outputs"]) == list(range(8))
    assert all(len(o) == 8 for o in out["outputs"].values())
    assert out["outputs"][0] == out["reference"] and out["tokens"] == 64


def _reference_defaults(path):
    """``{flag: default}`` of every ``p.add_argument`` in a reference script."""
    found = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords if k.arg == "default"}
            found[node.args[0].value.lstrip("-").replace("-", "_")] = kw.get("default")
    return found


@pytest.mark.parametrize("name", ["smax_vdn", "switch_game_dial", "lm_train"])
def test_reference_flags_keep_their_defaults(name):
    want = _reference_defaults(REFERENCE / f"{name}.py")
    got = vars(_example(name).parse_args([]))
    assert want and {k: got[k] for k in want} == want


def test_size_flags_default_to_the_reference_constants():
    q = vars(_example("quickstart").parse_args([]))
    assert (q["iterations"], q["eval_every"], q["ippo_iterations"]) == (3000, 1000, 3200)
    d = vars(_example("distributed_ippo").parse_args([]))
    assert (d["iterations"], d["executors"], d["executor_iterations"]) == (120 * 64, 4, 1500)
    source = (REFERENCE / "quickstart.py").read_text()
    for literal in ("num_iterations=3000", "eval_every=1000", "num_iterations=3200"):
        assert literal in source
    source = (REFERENCE / "distributed_ippo.py").read_text()
    for literal in ("120 * 64, num_envs=16", "1500, 8, mesh", "make_auto_mesh((4,)"):
        assert literal in source


@pytest.mark.parametrize("name", EXAMPLES)
def test_every_example_needs_a_device_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main([])


@pytest.mark.parametrize("name", ["quickstart", "lm_train"])
def test_learning_assertion_is_made_at_the_reference_sizes_only(name):
    mod = _example(name)
    assert mod.at_reference_sizes(mod.parse_args(CPU), mod.parse_args, mod.SIZE_FLAGS)
    for flag in mod.SIZE_FLAGS:
        smaller = str(getattr(mod.parse_args([]), flag) // 2)
        args = mod.parse_args(["--" + flag.replace("_", "-"), smaller, *CPU])
        assert not mod.at_reference_sizes(args, mod.parse_args, mod.SIZE_FLAGS)
