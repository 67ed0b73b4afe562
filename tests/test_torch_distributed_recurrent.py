"""Gradient sync of the recurrent systems, and the sharded runner at one rank: against JAX.

With `tests/test_torch_distributed.py`'s world (`run_cases`: one spawned
2-rank gloo world on the CPU, built in a module fixture):

* one update with ``distributed_axis="data"`` of rec-MADQN (linear core,
  matrix_game; the scan's plain version) and DIAL (switch_game, the
  channel on): both ranks from the same train state on their own data,
  the reference's draws injected per rank, against JAX's
  ``jax.vmap(update, axis_name="data")`` over the same two converted
  states: the synced gradients and the losses at 1e-5, params and
  optimizer state at 1e-4 (as their single-rank tests hold them), both
  ranks' params equal bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.buffer import RolloutState  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.systems import registry  # noqa: E402
from test_torch_distributed import (  # noqa: E402
    WORLD,
    _keys,
    _stack,
    check_synced_update,
    run_cases,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rec_madqn_case():
    import test_torch_rec_madqn as rq
    import test_torch_replay_systems as rs
    from repro.core import buffer as jbuf
    from repro.envs import make_env as jax_make_env
    from repro.nn.recurrent import window_start_carry
    from repro.systems import registry as jreg
    from repro_torch.convert import seq_buffer_from_jax

    overrides = dict(rq.SMALL, recurrent_core="linear")
    env_kwargs = {"horizon": rq.HORIZON}
    jsys = jreg.make_system("rec_madqn", jax_make_env("matrix_game", **env_kwargs),
                            distributed_axis="data", **overrides)
    tsys = registry.make_system("rec_madqn", make_env("matrix_game", **env_kwargs), **overrides)
    jtrain, ttrain = rs.init_from_port(jsys, tsys)
    observe = jax.jit(jsys.observe)
    tables = []
    for r in range(WORLD):
        jb = jsys.init_buffer(rq.N)
        for row in rq._rows(tsys.spec, np.random.default_rng(r + 1), 16, 11):
            jb = observe(jb, row)
        tables.append(jb)
    keys, bs = _keys(), overrides["batch_size"]
    loss_fn = rs.closure(jsys.update, "loss_fn")
    initial_carry = rs.closure(jsys.update, "initial_carry")

    def run(train, buffer, key):
        win = jbuf.seq_sample(buffer, key, bs)
        carry0 = window_start_carry(win.extras, initial_carry, (bs,))
        grads = jax.grad(loss_fn)(train.params, train.target_params,
                                  win._replace(extras={}), carry0)
        return jsys.update(train, buffer, key), jax.lax.pmean(grads, "data")

    (jtrain2, _, jm), jgrads = jax.jit(jax.vmap(run, axis_name="data"))(
        _stack(jtrain, jtrain), _stack(*tables), jax.numpy.stack(keys))
    size = int(tables[0].size)
    return {
        "recipe": ("rec_madqn", "matrix_game", env_kwargs, overrides),
        "train": ttrain, "buffers": [seq_buffer_from_jax(jb) for jb in tables],
        "draws": [{"idx": [torch.from_numpy(np.array(jax.random.randint(k, (bs,), 0, size)))]}
                  for k in keys],
        "jax": (jtrain2, jm, jgrads), "tol": 1e-4, "replay": True,
    }


def _dial_case():
    import test_torch_dial as dl
    import test_torch_replay_systems as rs
    from repro.envs import make_env as jax_make_env
    from repro.systems import registry as jreg

    jsys = jreg.make_system("dial", jax_make_env("switch_game"), distributed_axis="data",
                            **dl.SMALL)
    tsys = registry.make_system("dial", make_env("switch_game"), **dl.SMALL)
    jtrain, ttrain = rs.init_from_port(jsys, tsys)
    ids = list(tsys.spec.agent_ids)
    observe = jax.jit(jsys.observe)
    tables = []
    for r in range(WORLD):
        jb = jsys.init_buffer(dl.N)
        for row in dl._rows(np.random.default_rng(r + 1), ids, False, 6):
            jb = observe(jb, row)
        tables.append(jb)
    keys = _keys()
    loss_fn = rs.closure(jsys.update, "loss_fn")

    def run(train, buffer, key):
        grads = jax.grad(loss_fn)(train.params, train.target_params, buffer.storage, key)
        return jsys.update(train, buffer, key), jax.lax.pmean(grads, "data")

    (jtrain2, _, jm), jgrads = jax.jit(jax.vmap(run, axis_name="data"))(
        _stack(jtrain, jtrain), _stack(*tables), jax.numpy.stack(keys))
    return {
        "recipe": ("dial", "switch_game", {}, dl.SMALL),
        "train": ttrain,
        "buffers": [RolloutState(params_from_jax(jb.storage), int(jb.t)) for jb in tables],
        "draws": [{"noise": dl._bptt_noise(k, len(ids), 6)} for k in keys],
        "jax": (jtrain2, jm, jgrads), "tol": 1e-4, "replay": True,
    }

CASES = {"rec_madqn": _rec_madqn_case, "dial": _dial_case}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """This file's cases, in one spawned 2-rank gloo world."""
    return run_cases(CASES, tmp_path_factory.mktemp("world"), {})


@pytest.mark.parametrize("name", list(CASES))
def test_synced_update_matches_jax_vmap_pmean(world, name):
    check_synced_update(world, name)
