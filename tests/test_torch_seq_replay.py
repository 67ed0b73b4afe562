"""Sequence replay, `burn_in_carry` and DIAL's channel: the port against the JAX package.

* `seq_add` step by step against `repro.core.buffer.seq_add` on the same
  numpy stream, exactly: the windows, the ring and the cursors, with a
  stride below, at and above the window, wraps at capacity and more envs
  than slots; ``size`` equals `seq_expected_size` (the port's and the
  reference's) after every step;
* `seq_sample` against the reference's with its window indices injected,
  and seed lanes (one table a lane) against each lane's own table; the
  converters carry a vmapped JAX table across and back;
* `burn_in_carry` on both cores: it warms the carry exactly as the
  reference's, keeps nothing for a backward pass, gives no gradient to
  the params or the start carry, and passes a zero-length prefix through;
* `dru` (with the reference's noise draw injected) and
  `BroadcastedCommunication.route` / ``incoming_size`` at 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import buffer as jbuf  # noqa: E402
from repro.core.modules import communication as jcomm  # noqa: E402
from repro.nn import recurrent as jrec  # noqa: E402
from repro_torch import lanes  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_jax,
    params_to_jax,
    seq_buffer_from_jax,
    seq_buffer_to_jax,
)
from repro_torch.core import buffer as tbuf  # noqa: E402
from repro_torch.core.modules import BroadcastedCommunication, dru  # noqa: E402
from repro_torch.nn import LinearScannedRNN, ScannedRNN, burn_in_carry  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-6


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _example():
    return {"x": np.zeros((), np.int32), "obs": np.zeros((3,), np.float32),
            "h": {"a": np.zeros((2,), np.float32)}}


def _stream(rng, num_envs, steps):
    """``steps`` items of ``num_envs`` rows; x = step * 1000 + env tells every row apart."""
    return [{"x": (np.arange(num_envs) + 1000 * t).astype(np.int32),
             "obs": rng.normal(size=(num_envs, 3)).astype(np.float32),
             "h": {"a": rng.normal(size=(num_envs, 2)).astype(np.float32)}}
            for t in range(steps)]


def _check_table(tstate, jstate):
    for got, want in zip(tree_leaves((tstate.storage, tstate.acc)),
                         jax.tree_util.tree_leaves((jstate.storage, jstate.acc)), strict=True):
        _eq(got, want)
    assert (tstate.t, tstate.insert_pos, tstate.size) == (
        int(jstate.t), int(jstate.insert_pos), int(jstate.size))
    assert all(isinstance(v, int) for v in (tstate.t, tstate.insert_pos, tstate.size))


@pytest.mark.parametrize("capacity,window_len,num_envs,stride,steps", [
    (12, 4, 2, 2, 20),   # stride below the window: windows overlap, wraps at capacity
    (9, 3, 2, 3, 17),    # stride = window: R2D2's default tiling
    (10, 2, 3, 5, 23),   # stride above the window: steps skipped between windows
    (3, 4, 5, 1, 9),     # more envs than slots: the last `capacity` windows stay
    (7, 1, 2, 1, 8),     # one-step windows
])
def test_seq_add_matches_the_reference(capacity, window_len, num_envs, stride, steps):
    rng = np.random.default_rng(capacity)
    jstate = jbuf.seq_init(_example(), capacity, window_len, num_envs)
    tstate = tbuf.seq_init(params_from_jax(_example()), capacity, window_len, num_envs, "cpu")
    assert tstate.lanes is None
    jadd = jax.jit(lambda s, x: jbuf.seq_add(s, x, stride=stride))
    for t, item in enumerate(_stream(rng, num_envs, steps)):
        jstate = jadd(jstate, item)
        tstate = tbuf.seq_add(tstate, params_from_jax(item), stride=stride)
        _check_table(tstate, jstate)
        want = jbuf.seq_expected_size(t + 1, capacity, window_len, num_envs, stride)
        assert tstate.size == want == tbuf.seq_expected_size(
            t + 1, capacity, window_len, num_envs, stride)
        assert tbuf.seq_can_sample(tstate, 2) == bool(jbuf.seq_can_sample(jstate, 2))
    assert tstate.size > 0


def test_seq_sample_matches_the_reference_with_its_indices(monkeypatch):
    capacity, window_len, num_envs, stride, batch = 16, 4, 3, 2, 5
    jstate = jbuf.seq_init(_example(), capacity, window_len, num_envs)
    for item in _stream(np.random.default_rng(0), num_envs, 13):
        jstate = jbuf.seq_add(jstate, item, stride=stride)
    tstate = seq_buffer_from_jax(jstate)
    key = jax.random.key(4)
    want = jbuf.seq_sample(jstate, key, batch)
    idx = np.array(jax.random.randint(key, (batch,), 0, max(int(jstate.size), 1)))
    monkeypatch.setattr(tbuf, "sample_indices", lambda s, g, n: torch.from_numpy(idx))
    got = tbuf.seq_sample(tstate, None, batch)
    assert got["x"].shape == (window_len, batch)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
        _eq(g, w)
    # whole, time-ordered windows
    cols = got["x"].numpy().T
    assert (np.diff(cols, axis=1) == 1000).all()


def test_seq_lanes_are_tables_of_their_own_and_cross_the_converter():
    capacity, window_len, num_envs, stride, S = 8, 3, 2, 2, 3
    rng = np.random.default_rng(1)
    streams = [_stream(rng, num_envs, 11) for _ in range(S)]
    tstate = tbuf.seq_init(params_from_jax(_example()), capacity, window_len, (S, num_envs),
                           "cpu")
    assert tstate.lanes == S
    single = [tbuf.seq_init(params_from_jax(_example()), capacity, window_len, num_envs, "cpu")
              for _ in range(S)]
    jstate = jax.vmap(lambda _: jbuf.seq_init(_example(), capacity, window_len, num_envs))(
        jnp.arange(S))
    jadd = jax.jit(jax.vmap(lambda s, x: jbuf.seq_add(s, x, stride=stride)))
    for t in range(11):
        items = [params_from_jax(streams[s][t]) for s in range(S)]
        tstate = tbuf.seq_add(tstate, lanes.stack(items), stride=stride)
        single = [tbuf.seq_add(single[s], items[s], stride=stride) for s in range(S)]
        jstate = jadd(jstate, jax.tree_util.tree_map(
            lambda *xs: np.stack(xs), *[streams[s][t] for s in range(S)]))
    for s in range(S):
        for got, want in zip(tree_leaves((tstate.storage, tstate.acc)),
                             tree_leaves((single[s].storage, single[s].acc))):
            _eq(got[s], want.numpy())
    # the vmapped reference table, across and back
    back = seq_buffer_from_jax(jstate)
    assert back.lanes == S
    assert (back.t, back.insert_pos, back.size) == (tstate.t, tstate.insert_pos, tstate.size)
    for got, want in zip(tree_leaves((back.storage, back.acc)),
                         tree_leaves((tstate.storage, tstate.acc)), strict=True):
        _eq(got, want.numpy())
    for got, want in zip(tree_leaves(seq_buffer_to_jax(tstate)),
                         jax.tree_util.tree_leaves(jstate), strict=True):
        np.testing.assert_array_equal(got, np.asarray(want))
    # each lane samples its own table with its own generator, time-major (T, S, B)
    gens = lanes.generators([3, 4, 5], "cpu")
    got = tbuf.seq_sample(tstate, gens, 4)
    assert got["obs"].shape == (window_len, S, 4, 3)
    for s, seed in enumerate((3, 4, 5)):
        one = tbuf.seq_sample(single[s], torch.Generator().manual_seed(seed), 4)
        for x, y in zip(tree_leaves(got), tree_leaves(one)):
            _eq(x[:, s], y.numpy())


# ---------------------------------------------------------------- burn-in


def _core(kind):
    cls = {"gru": ScannedRNN, "linear": LinearScannedRNN}[kind]
    jcls = {"gru": jrec.ScannedRNN, "linear": jrec.LinearScannedRNN}[kind]
    return cls(3, 4), jcls(3, 4)


@pytest.mark.parametrize("kind", ["gru", "linear"])
def test_burn_in_carry_warms_exactly_and_stops_gradients(kind):
    core, jcore = _core(kind)
    params = core.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(3, 2, 3)).astype(np.float32)
    resets = np.array([[False, False], [True, False], [False, False]])
    c0 = rng.normal(size=(2, 4)).astype(np.float32)
    junroll = lambda c, x, r: jcore.unroll(params_to_jax(params), c, x, r)
    want = jrec.burn_in_carry(junroll, c0, xs, resets)

    p = tree_map(lambda x: x.clone().requires_grad_(True), params)
    c0_t = torch.from_numpy(c0).requires_grad_(True)
    unroll = lambda c, x, r: core.unroll(p, c, x, r)
    warmed = burn_in_carry(unroll, c0_t, torch.from_numpy(xs), torch.from_numpy(resets))
    np.testing.assert_allclose(warmed.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    direct, _ = core.unroll(p, c0_t, torch.from_numpy(xs), torch.from_numpy(resets))
    _eq(warmed, direct.detach().numpy())
    # nothing kept for a backward pass; a loss through it reaches no parameter
    assert warmed.grad_fn is None and not warmed.requires_grad
    assert direct.grad_fn is not None  # the unstopped unroll does build a graph
    leaves = tree_leaves(p) + [c0_t]
    only_direct = torch.autograd.grad((direct ** 2).sum(), leaves, retain_graph=True)
    grads = torch.autograd.grad((direct ** 2).sum() + (warmed ** 2).sum(), leaves)
    for g, d in zip(grads, only_direct):
        _eq(g, d.numpy())
    assert max(float(g.abs().max()) for g in only_direct) > 1e-6


@pytest.mark.parametrize("kind", ["gru", "linear"])
def test_burn_in_carry_zero_length_prefix_passes_carry_through(kind):
    core, _ = _core(kind)
    params = core.init(torch.Generator().manual_seed(0))
    c0 = torch.randn(2, 4, generator=torch.Generator().manual_seed(1)).requires_grad_(True)
    calls = []
    unroll = lambda c, x, r: calls.append(1) or core.unroll(params, c, x, r)
    out = burn_in_carry(unroll, c0, torch.zeros(0, 2, 3), torch.zeros(0, 2, dtype=torch.bool))
    assert not calls and not out.requires_grad
    _eq(out, c0.detach().numpy())


# ---------------------------------------------------------------- channel


def test_dru_matches_the_reference():
    m = np.array([[-2.0, 0.5], [3.0, 0.0], [0.1, -0.1]], np.float32)
    key = jax.random.key(0)
    noise = torch.from_numpy(np.array(jax.random.normal(key, m.shape)))
    for training in (True, False):
        want = jcomm.dru(m, key, 0.5, training)
        got = dru(torch.from_numpy(m), noise if training else None, 0.5, training)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
        assert got.dtype == torch.float32
    _eq(dru(torch.from_numpy(m), None, 0.5, False), [[0, 1], [1, 0], [1, 0]])
    # training is differentiable, with the reference's gradient
    x = torch.from_numpy(m).requires_grad_(True)
    (g,) = torch.autograd.grad(dru(x, noise, 0.5, True).sum(), [x])
    jg = jax.grad(lambda v: jcomm.dru(v, key, 0.5, True).sum())(m)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=TOL, rtol=TOL)
    assert (g.abs() > 0).all()


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n", [2, 3])
def test_route_and_incoming_size_match_the_reference(shared, n):
    rng = np.random.default_rng(n)
    msgs = {f"agent_{i}": rng.normal(size=(5, 2)).astype(np.float32) for i in range(n)}
    jc = jcomm.BroadcastedCommunication(channel_size=2, shared=shared)
    tc = BroadcastedCommunication(channel_size=2, shared=shared)
    want = jc.route(msgs)
    got = tc.route(params_from_jax(msgs))
    assert sorted(got) == sorted(want)
    for a in msgs:
        np.testing.assert_allclose(got[a].numpy(), np.asarray(want[a]), atol=TOL, rtol=TOL)
    assert tc.incoming_size(n) == jc.incoming_size(n) == got["agent_0"].shape[-1]
    if shared and n == 3:  # agent_0 hears the mean of the other two
        np.testing.assert_allclose(got["agent_0"].numpy(),
                                   (msgs["agent_1"] + msgs["agent_2"]) / 2, atol=TOL)
