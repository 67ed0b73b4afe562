"""The port's checkpoints (`repro_torch.checkpoint`) against the JAX package's format.

* a round trip keeps every leaf bitwise, bfloat16 included, and each
  restored tensor takes the target leaf's dtype and device; Python-int
  update counts (the replay family's) come back as ints;
* `latest_step` picks the highest step; a missing key raises `KeyError`;
* the keys the port writes for a `TrainState` are the keys the JAX package
  writes for the same one (ippo, rec_ippo, vdn): a `TrainState` JAX saved
  restores in the port equal to `convert.params_from_jax` of it, bitwise,
  and one the port saved restores in JAX equal to the original;
* `fresh_system_state` carries a restored trainer into new envs.

Bitwise throughout: a checkpoint stores values, it computes nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.bench.throughput import smoke_overrides as jax_smoke  # noqa: E402
from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.systems.registry import make_pair as jax_make_pair  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.convert import replay_train_from_jax  # noqa: E402
from repro_torch.core import train_anakin  # noqa: E402
from repro_torch.serve import fresh_system_state  # noqa: E402
from repro_torch.systems.registry import make_pair, smoke_overrides  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"
SYSTEMS = ["ippo", "rec_ippo", "vdn"]


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_roundtrip_keeps_dtypes_and_values(tmp_path):
    tree = {
        "layers": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
        "scale": torch.linspace(-2, 2, 5).to(torch.bfloat16),
        "steps": torch.tensor(7, dtype=torch.int32),
        "count": 11,
        "opt": ((), {"mu": torch.randn(2, 3, generator=torch.Generator().manual_seed(0))}),
    }
    d = str(tmp_path)
    save_checkpoint(d, 42, tree)
    assert latest_step(d) == 42
    target = tree_map(lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else 0, tree)
    restored = restore_checkpoint(d, 42, target)
    _equal(tree, restored)
    assert restored["scale"].dtype == torch.bfloat16 and isinstance(restored["count"], int)


def test_latest_step_picks_max(tmp_path):
    d = str(tmp_path)
    assert latest_step(d + "/absent") is None
    for s in (1, 10, 5):
        save_checkpoint(d, s, {"x": torch.zeros(())})
    assert latest_step(d) == 10


def test_missing_key_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"x": torch.zeros(())})
    with pytest.raises(KeyError, match="'y'"):
        restore_checkpoint(d, 1, {"y": torch.zeros(())})


def _jax_train(name, seed=0):
    _, system = jax_make_pair(name, "matrix_game", **jax_smoke(name))
    return system.init_train(jax.random.key(seed))


def _port_train(name, seed=0):
    _, system = make_pair(name, "matrix_game", **smoke_overrides(name))
    return system.init_train(torch.Generator(CPU).manual_seed(seed))


def _from_jax(name, train):
    return replay_train_from_jax(train) if name == "vdn" else params_from_jax(train)


@pytest.mark.parametrize("name", SYSTEMS)
def test_keys_equal_the_jax_packages(name, tmp_path):
    jax_save(str(tmp_path / "jax"), 0, _jax_train(name))
    save_checkpoint(str(tmp_path / "port"), 0, _port_train(name))
    with np.load(tmp_path / "jax" / "ckpt_00000000.npz") as a, \
            np.load(tmp_path / "port" / "ckpt_00000000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert {k: (a[k].dtype, a[k].shape) for k in a.files} == \
            {k: (b[k].dtype, b[k].shape) for k in b.files}


@pytest.mark.parametrize("name", SYSTEMS)
def test_jax_saved_train_state_restores_in_the_port(name, tmp_path):
    jtrain = _jax_train(name, seed=5)
    jax_save(str(tmp_path), 3, jtrain)
    restored = restore_checkpoint(str(tmp_path), 3, _port_train(name))
    _equal(_from_jax(name, jtrain), restored)


@pytest.mark.parametrize("name", SYSTEMS)
def test_port_saved_train_state_restores_in_jax(name, tmp_path):
    train = _port_train(name, seed=4)
    save_checkpoint(str(tmp_path), 2, train)
    restored = jax_restore(str(tmp_path), 2, _jax_train(name))
    want = params_to_jax(train._replace(steps=()))
    for x, y in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(restored._replace(steps=()))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert int(restored.steps) == int(train.steps)
    assert jnp.asarray(restored.steps).dtype == jnp.int32


def test_fresh_system_state_carries_the_restored_trainer(tmp_path):
    _, system = make_pair("ippo", "matrix_game", **smoke_overrides("ippo"))
    st, _ = train_anakin(system, 0, 32, 4, device=CPU)
    save_checkpoint(str(tmp_path), 32, st.train)
    train = restore_checkpoint(str(tmp_path), 32, _port_train("ippo"))
    fresh = fresh_system_state(system, train, torch.Generator(CPU).manual_seed(1), 6)
    _equal(st.train, fresh.train)
    assert fresh.buffer.t == 0 and fresh.timestep.step_type.shape == (6,)
