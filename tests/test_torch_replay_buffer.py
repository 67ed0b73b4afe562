"""The port's replay table (`repro_torch.core.buffer`) against `repro.core.buffer`.

The reference's own cases (`tests/test_buffer.py`), each on numpy inputs
from a seed fed to both packages, compared exactly (the table only moves
numbers):

* FIFO overwrite and size over many adds, batches that wrap within one add;
* sampling over the filled region, the JAX indices injected;
* the fill threshold, read from Python ints (no device read);
* pytree items, cast to the table's dtypes on write;
* seed lanes: one table a lane, against the vmapped reference, and lane
  ``s`` against the single table with its generator;
* the conversion of a table between the packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import buffer as jbuf  # noqa: E402
from repro_torch.convert import buffer_from_jax, buffer_to_jax, params_from_jax  # noqa: E402
from repro_torch.core import buffer as tbuf  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _item():
    """A nested row: float obs of two widths, an int action, a scalar reward."""
    return {"obs": {"a": np.zeros(3, np.float32), "b": np.zeros(2, np.float32)},
            "act": np.zeros((), np.int32), "r": np.zeros((), np.float32)}


def _rows(rng, n, lead=()):
    return {"obs": {"a": rng.normal(size=(*lead, n, 3)).astype(np.float32),
                    "b": rng.normal(size=(*lead, n, 2)).astype(np.float32)},
            "act": rng.integers(0, 5, size=(*lead, n)).astype(np.int32),
            "r": rng.normal(size=(*lead, n)).astype(np.float32)}


def _init_both(capacity, lanes=None):
    item = _item()
    if lanes is None:
        j = jbuf.buffer_init(item, capacity)
    else:
        j = jax.vmap(lambda _: jbuf.buffer_init(item, capacity))(jnp.arange(lanes))
    t = tbuf.buffer_init(params_from_jax(item), capacity, "cpu", lanes)
    return j, t


def _assert_same(t: tbuf.BufferState, j):
    assert isinstance(t.insert_pos, int) and isinstance(t.size, int)
    assert t.insert_pos == int(np.asarray(j.insert_pos).flat[0])
    assert t.size == int(np.asarray(j.size).flat[0])
    for x, y in zip(tree_leaves(t.storage), jax.tree_util.tree_leaves(j.storage), strict=True):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("capacity,batches", [
    (10, [4, 4, 4, 4]),        # wraps inside the third add
    (7, [3, 5, 6, 2, 7, 1]),   # a batch of exactly the capacity
    (64, [16] * 5),            # overwrites the oldest rows
    (50, [1, 49, 3]),          # fills to the brim, then wraps
])
def test_fifo_overwrite_and_size_match(capacity, batches):
    rng = np.random.default_rng(capacity)
    j, t = _init_both(capacity)
    for b in batches:
        rows = _rows(rng, b)
        j = jbuf.buffer_add(j, rows)
        t = tbuf.buffer_add(t, params_from_jax(rows))
        _assert_same(t, j)


def test_a_batch_larger_than_the_table_keeps_its_last_rows():
    # the reference's scatter writes one slot twice here (XLA leaves the
    # winner unspecified); the port keeps the batch's last `capacity` rows
    t = tbuf.buffer_init({"x": torch.zeros((), dtype=torch.int32)}, 5, "cpu")
    t = tbuf.buffer_add(t, {"x": torch.arange(3, dtype=torch.int32)})
    t = tbuf.buffer_add(t, {"x": torch.arange(100, 112, dtype=torch.int32)})
    assert (t.insert_pos, t.size) == ((3 + 12) % 5, 5)
    # row k of the batch lands in slot (3 + k) % 5
    want = np.zeros(5, np.int32)
    for k in range(7, 12):
        want[(3 + k) % 5] = 100 + k
    np.testing.assert_array_equal(t.storage["x"].numpy(), want)


@pytest.mark.parametrize("capacity,fill,batch", [(16, 5, 8), (16, 16, 16), (8, 1, 3)])
def test_sample_from_the_filled_region_matches(capacity, fill, batch, monkeypatch):
    rng = np.random.default_rng(fill)
    j, t = _init_both(capacity)
    rows = _rows(rng, fill)
    j, t = jbuf.buffer_add(j, rows), tbuf.buffer_add(t, params_from_jax(rows))
    key = jax.random.key(fill)
    want = jbuf.buffer_sample(j, key, batch)
    idx = jax.random.randint(key, (batch,), 0, fill)
    monkeypatch.setattr(tbuf, "sample_indices", lambda s, g, n: torch.from_numpy(np.array(idx)))
    got = tbuf.buffer_sample(t, None, batch)
    for x, y in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    monkeypatch.undo()
    # the port's own draws stay inside the filled rows
    idx = tbuf.sample_indices(t, torch.Generator().manual_seed(0), 1000)
    assert idx.shape == (1000,) and int(idx.min()) >= 0
    assert int(idx.max()) < fill


def test_can_sample_threshold_is_a_host_decision():
    t = tbuf.buffer_init({"x": torch.zeros(())}, 16, "cpu")
    assert tbuf.buffer_can_sample(t, 4) is False
    t = tbuf.buffer_add(t, {"x": torch.zeros(4)})
    assert tbuf.buffer_can_sample(t, 4) is True
    j = jbuf.buffer_add(jbuf.buffer_init({"x": jnp.zeros(())}, 16), {"x": jnp.zeros(4)})
    assert bool(jbuf.buffer_can_sample(j, 4)) and not bool(jbuf.buffer_can_sample(j, 5))
    assert tbuf.buffer_can_sample(t, 5) is False


def test_pytree_items_roundtrip_and_cast_on_write():
    item = {"obs": {"a": jnp.zeros((3,)), "b": jnp.zeros((2,))}, "r": jnp.zeros(()),
            "k": jnp.zeros((), jnp.int32)}
    batch = {"obs": {"a": np.full((2, 3), 1.5, np.float64), "b": np.ones((2, 2), np.float32)},
             "r": np.ones((2,), np.int64), "k": np.array([2.9, -1.2], np.float32)}
    j = jbuf.buffer_add(jbuf.buffer_init(item, 8), batch)
    t = tbuf.buffer_add(tbuf.buffer_init(params_from_jax(item), 8, "cpu"), params_from_jax(batch))
    _assert_same(t, j)
    assert t.storage["k"].dtype == torch.int32 and t.storage["r"].dtype == torch.float32
    out = tbuf.buffer_sample(t, torch.Generator().manual_seed(0), 2)
    assert out["obs"]["a"].shape == (2, 3)
    np.testing.assert_array_equal(out["r"].numpy(), np.ones((2,)))


def test_seed_lanes_match_the_vmapped_reference(monkeypatch):
    lanes, capacity, batch = 3, 12, 5
    rng = np.random.default_rng(7)
    j, t = _init_both(capacity, lanes)
    for _ in range(4):  # 20 rows a lane into 12: wraps within an add
        rows = _rows(rng, 4, (lanes,))
        j = jax.vmap(jbuf.buffer_add)(j, rows)
        t = tbuf.buffer_add(t, params_from_jax(rows))
        _assert_same(t, j)
    keys = jax.random.split(jax.random.key(3), lanes)
    want = jax.vmap(lambda s, k: jbuf.buffer_sample(s, k, batch))(j, keys)
    idx = jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, capacity))(keys)
    monkeypatch.setattr(tbuf, "sample_indices", lambda s, g, n: torch.from_numpy(np.array(idx)))
    got = tbuf.buffer_sample(t, None, batch)
    for x, y in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
        assert x.shape[:2] == (lanes, batch)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    monkeypatch.undo()
    # lane s samples what the single table of lane s samples with its generator
    gens = tuple(torch.Generator().manual_seed(s) for s in range(lanes))
    got = tbuf.buffer_sample(t, gens, batch)
    for s in range(lanes):
        one = tbuf.BufferState(_lane(t.storage, s), t.insert_pos, t.size)
        alone = tbuf.buffer_sample(one, torch.Generator().manual_seed(s), batch)
        for x, y in zip(tree_leaves(got), tree_leaves(alone), strict=True):
            assert torch.equal(x[s], y)
    # the conversion between the packages keeps the lanes and the cursors
    back = buffer_from_jax(j)
    assert back.lanes == lanes
    _assert_same(back, j)
    _assert_same(t, buffer_to_jax(back))


def _lane(tree, s):
    if isinstance(tree, dict):
        return {k: _lane(v, s) for k, v in tree.items()}
    return tree[s]
