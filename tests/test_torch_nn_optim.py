"""The port's layers, memory cores and optimizer against the JAX package.

Params are initialised by JAX and converted across (`repro_torch.convert`);
inputs are made with numpy.  Tolerances: 1e-5 for the layers and cores
(float32 matmuls summed in another order), 1e-6 for one optimizer step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.nn import layers as jl  # noqa: E402
from repro.nn import recurrent as jr  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.nn import layers as tl  # noqa: E402
from repro_torch.nn import recurrent as tr  # noqa: E402

TOL = 1e-5
OPT_TOL = 1e-6


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach()), np.asarray(want), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("activate_final", [False, True])
def test_dense_and_mlp(activate_final):
    rng = np.random.default_rng(0)
    x = _rand(rng, 5, 7)
    dense = jl.Dense(7, 3)
    p = dense.init(jax.random.key(0))
    _close(tl.Dense(7, 3).apply(params_from_jax(p), torch.from_numpy(x)),
           dense.apply(p, x))
    mlp = jl.MLP((7, 16, 16, 4), activate_final=activate_final)
    p = mlp.init(jax.random.key(1))
    got = tl.MLP((7, 16, 16, 4), activate_final=activate_final).apply(
        params_from_jax(p), torch.from_numpy(x)
    )
    _close(got, mlp.apply(p, x))


def test_gru_cell():
    rng = np.random.default_rng(1)
    cell = jl.GRUCell(6, 16)
    p = cell.init(jax.random.key(2))
    h, x = _rand(rng, 4, 16), _rand(rng, 4, 6)
    got = tl.GRUCell(6, 16).apply(params_from_jax(p), torch.from_numpy(h), torch.from_numpy(x))
    _close(got, cell.apply(p, h, x))


@pytest.mark.parametrize("kind", ["linear", "gru"])
@pytest.mark.parametrize("pattern", ["none", "all", "mid_window", "random"])
def test_core_step_and_unroll(kind, pattern):
    T, B, in_dim, hidden = 9, 4, 6, 16
    rng = np.random.default_rng(2)
    jcore, tcore = jr.make_core(kind, in_dim, hidden), tr.make_core(kind, in_dim, hidden)
    p = jcore.init(jax.random.key(3))
    pt = params_from_jax(p)
    xs, carry = _rand(rng, T, B, in_dim), _rand(rng, B, hidden)
    resets = {
        "none": None,
        "all": np.ones((T, B), bool),
        "mid_window": np.arange(T)[:, None].repeat(B, 1) == T // 2,
        "random": rng.random((T, B)) < 0.3,
    }[pattern]
    rt = None if resets is None else torch.from_numpy(resets)
    rj = None if resets is None else jnp.asarray(resets)

    h_t, y_t = tcore.step(pt, torch.from_numpy(carry), torch.from_numpy(xs[0]),
                          None if rt is None else rt[0])
    h_j, y_j = jcore.step(p, carry, xs[0], None if rj is None else rj[0])
    _close(h_t, h_j)
    _close(y_t, y_j)

    fin_t, hs_t = tcore.unroll(pt, torch.from_numpy(carry), torch.from_numpy(xs), rt)
    fin_j, hs_j = jcore.unroll(p, carry, xs, rj)
    _close(hs_t, hs_j)
    _close(fin_t, fin_j)


def test_reset_carry_and_window_start():
    rng = np.random.default_rng(4)
    carry = {"actor": _rand(rng, 5, 3), "critic": _rand(rng, 5, 3)}
    reset = rng.random(5) < 0.5
    got = tr.reset_carry(params_from_jax(carry), torch.from_numpy(reset))
    want = jr.reset_carry(carry, jnp.asarray(reset))
    for k in carry:
        _close(got[k], want[k], tol=0)
    extras = {"carry_in": {"actor": _rand(rng, 4, 5, 3)}}
    start = tr.window_start_carry(params_from_jax(extras), None, (5,), "cpu")
    _close(start["actor"], extras["carry_in"]["actor"][0], tol=0)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])  # clipping active / inactive
def test_clip_adamw_step(max_norm):
    rng = np.random.default_rng(5)
    params = {"a": {"w": _rand(rng, 4, 3), "b": _rand(rng, 3)}, "c": _rand(rng, 6)}
    grads = [jax.tree_util.tree_map(lambda x: _rand(rng, *x.shape), params) for _ in range(3)]
    jopt = jax_optim.chain(jax_optim.clip_by_global_norm(max_norm), jax_optim.adamw(3e-4))
    topt = optim.chain(optim.clip_by_global_norm(max_norm), optim.adamw(3e-4))
    jp, tp = params, params_from_jax(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(g, js, jp)
        jp = jax_optim.apply_updates(jp, ju)
        tu, ts = topt.update(params_from_jax(g), ts, tp)
        tp = optim.apply_updates(tp, tu)
    got, want = params_to_jax(tp), jax.tree_util.tree_map(np.asarray, jp)
    for path in (("a", "w"), ("a", "b"), ("c",)):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_allclose(g, w, atol=OPT_TOL, rtol=OPT_TOL)
    _close(optim.global_norm(tp), jax_optim.global_norm(jp))
    assert int(ts[1].count) == int(js[1].count) == 3


def test_convert_round_trips_named_tuples():
    from repro.core.types import Carry as JCarry, TrainState as JTrain
    from repro_torch.core.types import Carry, TrainState

    opt = jax_optim.chain(jax_optim.clip_by_global_norm(1.0), jax_optim.adamw(1e-3))
    params = {"w": jnp.ones((2, 3))}
    train = JTrain(params, params, opt.init(params), jnp.zeros((), jnp.int32))
    t = params_from_jax(train)
    assert isinstance(t, TrainState) and isinstance(t.opt_state[1], optim.AdamState)
    assert t.opt_state[0] == () and t.steps.dtype == torch.int32
    back = params_to_jax(t)
    np.testing.assert_array_equal(back.opt_state[1].nu["w"], np.zeros((2, 3), np.float32))
    c = params_from_jax(JCarry(hidden={"a": np.ones((2, 4), np.float32)}))
    assert isinstance(c, Carry) and c.message == ()
