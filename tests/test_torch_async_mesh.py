"""The async runner's actor sharding (`impala._shard_actors`) under a device mesh.

The counterpart of tests/test_distributed.py's
``test_async_runner_under_cpu_mesh``: ippo on matrix_game (hidden (32, 32),
rollout 8, 1 epoch, 2 minibatches), ``make_async(system, 16, 4, 2)``
under `sharding.enter_mesh` of a ``("data",)`` mesh over a spawned 2-rank
gloo world.  The reference's contract: the learner took steps, every
param is finite, nothing was dropped.

Under the mesh, after each tick's unrolls `_shard_actors` takes the
program's own actor state (plain tensors, the same on every rank) as
replicated DTensors and lays every actor leaf out as ``Shard(0)`` over
``data`` (generators untouched); the next unrolls run on those shards, the
chunks are gathered whole for the queue, and the learner ends bitwise
where the same program ends outside the mesh.  Outside a mesh
`_shard_actors` returns its input's tensors themselves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import collective  # noqa: E402
from repro_torch.distributed import impala  # noqa: E402
from repro_torch.systems.registry import make_pair  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

PPO = dict(hidden_sizes=(32, 32), rollout_len=8, epochs=1, num_minibatches=2)


def _system():
    return make_pair("ippo", "matrix_game", **PPO)[1]


def _placements(tree):
    return sorted({(type(x).__name__,
                    tuple((type(p).__name__, getattr(p, "dim", None)) for p in x.placements)
                    if hasattr(x, "placements") else ())
                   for x in tree_leaves(tree)})


def _world(rank, world_size, device):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as sh

    torch.set_num_threads(1)  # two ranks on the CPU's cores: no oversubscription
    mesh = init_device_mesh("cpu", (world_size,), mesh_dim_names=("data",))
    program = impala.make_async(_system(), 16, 4, 2, device=device)
    out = {}
    with sh.enter_mesh(mesh):
        state, metrics = program(0)
        out["mesh"] = {"steps": int(state.train.steps), "dropped": metrics["dropped"],
                       "params": state.train.params,
                       "actor_kinds": _placements(state.actors)}
    state, metrics = program(0)
    out["plain"] = {"steps": int(state.train.steps), "dropped": metrics["dropped"],
                    "params": state.train.params, "actor_kinds": _placements(state.actors)}
    return out


@pytest.fixture(scope="module")
def world():
    return collective.run_world(_world, 2, "gloo", "cpu", timeout_s=300.0)


def test_async_runner_under_a_gloo_mesh_meets_the_reference_contract(world):
    for rank in world:
        run = rank["mesh"]
        assert run["steps"] > 0
        assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(run["params"]))
        assert float(run["dropped"][-1]) == 0.0


def test_dtensor_actors_are_sharded_over_data_and_train_as_the_plain_run(world):
    for rank in world:
        run, plain = rank["mesh"], rank["plain"]
        assert run["steps"] == plain["steps"] > 0
        assert torch.equal(run["dropped"], plain["dropped"])
        # the program's own actor state, sharded by `_shard_actors` under the mesh
        assert run["actor_kinds"] == [("DTensor", (("Shard", 0),)), ("Generator", ())]
        assert plain["actor_kinds"] == [("Generator", ()), ("Tensor", ())]
        for got, want in zip(tree_leaves(run["params"]), tree_leaves(plain["params"])):
            assert type(got) is torch.Tensor and torch.equal(got, want)
    for got, want in zip(tree_leaves(world[1]["mesh"]["params"]),
                         tree_leaves(world[0]["mesh"]["params"])):
        assert torch.equal(got, want)


def test_shard_actors_outside_a_mesh_returns_its_tensors():
    program = impala.make_async(_system(), 16, 4, 2, device="cpu")
    actors = program.init_state(0).actors
    sharded = impala._shard_actors(actors)
    assert type(sharded) is type(actors)
    before, after = tree_leaves(actors), tree_leaves(sharded)
    assert len(before) == len(after) and all(a is b for a, b in zip(before, after))
    assert np.any([isinstance(x, torch.Generator) for x in after])
