"""One trainer ``update`` of MADQN and MADQN-fp: the port against the JAX package.

For both systems x matrix_game, spread and lbf x shared weights on and
off, from the same weights and replay rows with the JAX sample indices
injected (helpers in `tests/test_torch_replay_systems.py`): the loss and
every gradient at 1e-5 (a gradient's absolute error scaled by its leaf's
largest entry, see `close_grads`), then the params, the optimizer state,
the targets and the update count after it, with the update count at 0
(no target sync after the update) and at ``target_update_period - 1``
(the update syncs the targets).  `tests/test_torch_replay_update_mixed.py`
runs `check_update` for VDN and QMIX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import buffer as jbuf  # noqa: E402
from repro_torch.convert import replay_train_to_jax  # noqa: E402
from repro_torch.systems import offpolicy as toff  # noqa: E402
from test_torch_replay_systems import (  # noqa: E402
    ENVS,
    ROWS,
    SMALL,
    capture_grads,
    check_trained,
    close,
    close_grads,
    closure,
    filled_buffers,
    init_from_port,
    inject_samples,
    pair,
    random_rows,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def check_update(name, env_name, shared_weights, monkeypatch):
    """One update of ``name`` in each package from the same state, samples injected."""
    # shared weights start at update 0 (no sync after the update), per-agent
    # weights one update before the period (the update syncs the targets)
    steps = 0 if shared_weights else SMALL["target_update_period"] - 1
    jsys, tsys = pair(name, env_name, shared_weights=shared_weights, **SMALL)
    jtrain, ttrain = init_from_port(jsys, tsys, steps=steps)
    rows = random_rows(tsys.spec, np.random.default_rng(1), ROWS)
    jb, tb = filled_buffers(jsys, rows)
    key = jax.random.key(5)
    jtrain2, _, jm = jsys.update(jtrain, jb, key)
    batch = jbuf.buffer_sample(jb, key, SMALL["batch_size"])
    jloss, jgrads = jax.value_and_grad(closure(jsys.update, "loss_fn"))(
        jtrain.params, jtrain.target_params, batch, jtrain.steps)

    inject_samples(monkeypatch, key, ROWS, SMALL["batch_size"])
    seen = capture_grads(monkeypatch, toff)
    ttrain2, tb2, tm = tsys.update(ttrain, tb, None)
    assert tb2 is tb and len(seen) == 1
    loss, grads = seen[0]
    close(loss, jloss)
    close(tm["loss"], jm["loss"])
    assert tm["eps"] == pytest.approx(float(jm["eps"]), abs=0)
    close_grads(jax.tree_util.tree_leaves(replay_train_to_jax(ttrain._replace(params=grads)).params),
                jax.tree_util.tree_leaves(jgrads))
    check_trained(jtrain, jtrain2, ttrain2)
    synced = (steps + 1) % SMALL["target_update_period"] == 0
    assert (ttrain2.target_params is ttrain2.params) == synced
    if not synced:
        assert ttrain2.target_params is ttrain.target_params


@pytest.mark.parametrize("env_name", ENVS)
@pytest.mark.parametrize("name", ["madqn", "madqn-fp"])
@pytest.mark.parametrize("shared_weights", [True, False])
def test_update_matches(name, env_name, shared_weights, monkeypatch):
    check_update(name, env_name, shared_weights, monkeypatch)
