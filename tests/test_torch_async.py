"""The async actor/learner runner and its trajectory queue: the port against the JAX package.

* the reference's four queue tests (`tests/test_async.py`), each also
  held against `repro.core.buffer`'s queue on the same pushes and pops:
  storage, head and size after every step, through `convert.queue_*`;
* staleness 0 is anakin, bitwise: at one actor, a sync every tick and
  anakin's cadence (the rollout for ippo and rec-IPPO with the linear
  core, one step for vdn) the learner's params and optimizer state equal
  anakin's, and the acting stream is anakin's averaged a tick;
* the staleness trace at ``param_sync_every=4`` is ``0, 1, 2, 3, 0, ...``
  and 4 actors give 4 times the updates with nothing dropped;
* `default_unroll_len` agrees with the reference's for all 13 systems,
  and bad schedules raise the reference's errors;
* ``use_vtrace`` ippo trains finite under ``param_sync_every=2``, and the
  launcher's ``--runner async`` runs on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import buffer as jbuf  # noqa: E402
from repro.distributed import impala as jimpala  # noqa: E402
from repro.envs import make_env as jax_make_env  # noqa: E402
from repro.systems import registry as jreg  # noqa: E402
from repro_torch.convert import queue_from_jax, queue_to_jax  # noqa: E402
from repro_torch.core import buffer as tbuf  # noqa: E402
from repro_torch.core.system import make_anakin  # noqa: E402
from repro_torch.distributed.impala import (  # noqa: E402
    default_unroll_len,
    make_async,
    train_async,
)
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.launch import train_marl  # noqa: E402
from repro_torch.systems import registry  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PPO_SMOKE = dict(hidden_sizes=(32, 32), rollout_len=8, epochs=1, num_minibatches=2)
VDN_SMOKE = dict(hidden_sizes=(32, 32), batch_size=32, buffer_capacity=5_000, min_replay=64)


def leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


# ------------------------------------------------------- trajectory queue


class _Both:
    """The same queue in both packages, held equal after every push and pop."""

    def __init__(self, capacity):
        self.j = jbuf.queue_init({"x": jnp.zeros(())}, capacity)
        self.t = tbuf.queue_init({"x": torch.zeros(())}, capacity)
        self.check()

    def check(self):
        back = queue_from_jax(self.j)
        assert torch.equal(back.storage["x"], self.t.storage["x"])
        assert (back.head, back.size) == (self.t.head, self.t.size)
        got = queue_to_jax(self.t)
        np.testing.assert_array_equal(got.storage["x"], np.asarray(self.j.storage["x"]))
        assert int(got.head) == int(self.j.head) and int(got.size) == int(self.j.size)
        assert tbuf.queue_size(self.t) == int(jbuf.queue_size(self.j))
        assert tbuf.queue_capacity(self.t) == int(jbuf.queue_capacity(self.j))

    def push(self, v):
        self.j, jok = jbuf.queue_push(self.j, {"x": jnp.asarray(v)})
        self.t, ok = tbuf.queue_push(self.t, {"x": torch.tensor(v)})
        assert ok == bool(jok)
        self.check()
        return ok

    def pop(self):
        self.j, jitem = jbuf.queue_pop(self.j)
        self.t, item = tbuf.queue_pop(self.t)
        assert float(item["x"]) == float(jitem["x"])
        self.check()
        return float(item["x"])


def test_queue_fifo_order():
    q = _Both(3)
    for v in (1.0, 2.0, 3.0):
        assert q.push(v)
    assert tbuf.queue_capacity(q.t) == 3 and tbuf.queue_size(q.t) == 3
    assert [q.pop() for _ in range(3)] == [1.0, 2.0, 3.0] and tbuf.queue_size(q.t) == 0


def test_queue_overflow_drops_incoming():
    q = _Both(2)
    for v in (1.0, 2.0):
        q.push(v)
    assert not q.push(99.0) and tbuf.queue_size(q.t) == 2
    assert q.pop() == 1.0  # queued items untouched by the drop


def test_queue_pop_empty_leaves_queue_empty():
    q = _Both(2)
    q.pop()
    assert tbuf.queue_size(q.t) == 0 and q.t.head == 0


def test_queue_wraps_around():
    q = _Both(2)
    q.push(1.0)
    q.push(2.0)
    q.pop()
    q.push(3.0)  # reuses slot 0
    assert q.pop() == 2.0
    assert q.pop() == 3.0


def test_queue_keeps_host_leaves_and_casts_to_the_slot_dtype():
    q = tbuf.queue_init({"x": torch.zeros(2, dtype=torch.int32), "n": 0}, 2)
    q, _ = tbuf.queue_push(q, {"x": torch.tensor([1.7, 2.2]), "n": 5})
    q, item = tbuf.queue_pop(q)
    assert item["n"] == 5 and item["x"].dtype == torch.int32 and item["x"].tolist() == [1, 2]


# --------------------------------------------- staleness-0 bitwise parity


@pytest.mark.parametrize("name,overrides,iterations,unroll", [
    ("ippo", PPO_SMOKE, 32, None),
    ("rec_ippo", dict(PPO_SMOKE, recurrent_core="linear"), 16, None),
    ("vdn", VDN_SMOKE, 64, 1),
])
def test_async_staleness_zero_bitwise_matches_anakin(name, overrides, iterations, unroll):
    system = registry.make_system(name, make_env("matrix_game"), **overrides)
    st_a, m_a = make_anakin(system, iterations, 4, device="cpu")(1)
    st_b, m_b = make_async(system, iterations, 4, 1, param_sync_every=1, unroll_len=unroll,
                           device="cpu")(1)
    assert leaves_equal(st_a.train.params, st_b.train.params)
    assert leaves_equal(st_a.train.opt_state, st_b.train.opt_state)
    assert int(st_a.train.steps) == int(st_b.train.steps) == st_b.updates > 0
    # the acting stream is anakin's too: a tick's metric is the mean over its unroll
    u = unroll or PPO_SMOKE["rollout_len"]
    np.testing.assert_allclose(m_a["reward"].reshape(-1, u).mean(1).numpy(),
                               m_b["reward"].numpy(), rtol=1e-6)
    assert float(m_b["dropped"][-1]) == 0.0 and float(m_b["staleness"].max()) == 0.0


# ----------------------------------------------- staleness bound + scaling


def test_param_sync_every_bounds_staleness():
    system = registry.make_system("ippo", make_env("matrix_game"), **PPO_SMOKE)
    _, m = make_async(system, 64, 4, 1, param_sync_every=4, device="cpu")(0)
    assert m["staleness"].tolist() == [0.0, 1.0, 2.0, 3.0] * 2


def test_multi_actor_training_runs_and_scales_steps():
    system = registry.make_system("ippo", make_env("matrix_game"), **PPO_SMOKE)
    st1, _ = make_async(system, 16, 4, 1, device="cpu")(0)
    st4, m4 = make_async(system, 16, 4, 4, device="cpu")(0)
    # 4 actors deliver 4x the chunks -> 4x the updates for the same ticks
    assert int(st4.train.steps) == 4 * int(st1.train.steps) > 0
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(st4.train.params))
    assert float(m4["dropped"][-1]) == 0.0 and m4["queue_depth"].tolist() == [4.0, 4.0]
    assert m4["consumed"].tolist() == [4.0, 4.0]


def test_a_small_queue_drops_what_the_learner_cannot_take():
    system = registry.make_system("ippo", make_env("matrix_game"), **PPO_SMOKE)
    st, m = make_async(system, 24, 4, 3, queue_capacity=2, learner_pops_per_tick=1,
                       device="cpu")(0)
    # tick 0: 2 of 3 pushed, 1 popped; each later tick: 1 of 3 pushed, 1 popped
    assert m["dropped"].tolist() == [1.0, 3.0, 5.0] and st.dropped == 5
    assert m["queue_depth"].tolist() == [2.0, 2.0, 2.0] and int(st.train.steps) == 3


def test_train_async_wrapper_and_program_handles():
    system = registry.make_system("ippo", make_env("matrix_game"), **PPO_SMOKE)
    program = make_async(system, 16, 4, 2, device="cpu")
    assert program.unroll_len == 8 and program.num_ticks == 2
    st, m = train_async(system, 3, 16, 4, 2, device="cpu")
    assert st.tick == 2 and m["queue_depth"].shape == (2,)
    assert set(m) == {"reward", "done_frac", "episode_return", "queue_depth", "staleness",
                      "consumed", "dropped"}


def _env_for(name):
    """The first registered env the system runs on."""
    return next(e for e in sorted(registry.ENV_REGISTRY) if registry.compatibility(name, e)
                is None)


@pytest.mark.parametrize("name", sorted(registry.REGISTRY))
def test_default_unroll_len_matches_the_reference(name):
    env = _env_for(name)
    assert jreg.compatibility(name, env) is None
    _, jsys = jreg.make_pair(name, env)
    _, tsys = registry.make_pair(name, env)
    assert default_unroll_len(tsys) == jimpala.default_unroll_len(jsys)


def test_async_rejects_bad_schedule():
    system = registry.make_system("ippo", make_env("matrix_game"), **PPO_SMOKE)
    with pytest.raises(ValueError, match="multiple of the"):
        make_async(system, 30, 4, 1, device="cpu")
    with pytest.raises(ValueError, match="num_actors"):
        make_async(system, 16, 4, 0, device="cpu")
    with pytest.raises(ValueError, match="param_sync_every"):
        make_async(system, 16, 4, 1, param_sync_every=0, device="cpu")
    jsys = jreg.make_system("ippo", jax_make_env("matrix_game"), **PPO_SMOKE)
    with pytest.raises(ValueError, match="multiple of the"):
        jimpala.make_async(jsys, 30, 4, 1)


def test_vtrace_system_trains_under_staleness():
    system = registry.make_system("ippo", make_env("matrix_game"), use_vtrace=True, **PPO_SMOKE)
    st, m = make_async(system, 32, 4, 2, param_sync_every=2, device="cpu")(0)
    assert int(st.train.steps) > 0 and float(m["staleness"].max()) > 0
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(st.train.params))


def test_launcher_async_runner_on_the_cpu(capsys):
    out = train_marl.main(["--system", "ippo", "--env", "matrix_game", "--runner", "async",
                           "--num-actors", "2", "--param-sync-every", "2", "--iterations",
                           "256", "--num-envs", "4", "--eval-episodes", "4", "--device", "cpu"])
    assert out["dropped_chunks"] == 0.0 and out["staleness_mean"] > 0
    assert out["queue_depth_mean"] == 2.0 and out["env_steps"] == 256 * 4 * 2
    assert out["per_actor_steps_per_sec"] == pytest.approx(out["steps_per_sec"] / 2)
    assert "runner=async" in capsys.readouterr().out
