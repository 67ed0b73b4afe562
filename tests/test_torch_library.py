"""The port's library pieces against the JAX package: optimizers and schedules,
the functional layers and initializers, the data helpers, `shared_reward`.

* every optimizer (`scale`, `sgd` with and without momentum, `rmsprop`,
  `adam`, `adamw` with weight decay) over 5 steps of the same numpy
  gradients, with a float and with a schedule learning rate: updates,
  params and optimizer state within 1e-6 of `repro.optim`'s; the updates'
  dtypes equal the reference's on a bfloat16 / float32 tree;
* the three schedules at step 0, inside the warmup, mid-decay, the end and
  past it, as Python ints and as 0-d int32 tensors, within 1e-7;
* `Embed` (lookup and the tied `attend`), `RMSNorm`, `LayerNorm` and
  `Sequential` on params initialised by JAX and converted, within 1e-6,
  and every layer's ``axes()`` equal to the reference's;
* the new initializers by shape, dtype and moments (the draws cannot
  match JAX's): `truncated_normal` never leaves two standard deviations;
* `batch_trajectories`, `episode_returns` and `make_lm_batch` (on a device,
  and as DTensors on a 1-rank gloo mesh) against the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.data import tokens as jax_tokens  # noqa: E402
from repro.data import trajectory as jax_traj  # noqa: E402
from repro.envs import api as jax_api  # noqa: E402
from repro.nn import initializers as jax_init  # noqa: E402
from repro.nn import layers as jl  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.data import batch_trajectories, episode_returns, make_lm_batch  # noqa: E402
from repro_torch.distributed import collective  # noqa: E402
from repro_torch.envs import api  # noqa: E402
from repro_torch.nn import initializers  # noqa: E402
from repro_torch.nn import layers as tl  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them fastest and
    leaves the other cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


OPT_TOL = 1e-6
SCHED_TOL = 1e-7
LAYER_TOL = 1e-6
STEPS = 5


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def _leaves_close(got, want, tol):
    got, want = tree_leaves(params_to_jax(got)), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).shape == np.asarray(w).shape
        _close(np.asarray(g, np.float32), np.asarray(w, np.float32), tol)


# ------------------------------------------------------------- optimizers

SCHEDULE = dict(peak_value=1e-2, warmup_steps=2, decay_steps=5, end_value=1e-3)
OPTIMIZERS = {
    "scale": lambda o, lr: o.scale(-0.5),
    "sgd": lambda o, lr: o.sgd(lr),
    "sgd_momentum": lambda o, lr: o.sgd(lr, momentum=0.9),
    "rmsprop": lambda o, lr: o.rmsprop(lr, decay=0.95),
    "adam": lambda o, lr: o.adam(lr),
    "adamw": lambda o, lr: o.adamw(lr, weight_decay=0.1),
}


def _learning_rate(package, kind):
    return 1e-2 if kind == "float" else package.linear_warmup_cosine_decay(**SCHEDULE)


@pytest.mark.parametrize("kind", ["float", "schedule"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_reference(name, kind):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    jopt = OPTIMIZERS[name](jax_optim, _learning_rate(jax_optim, kind))
    topt = OPTIMIZERS[name](optim, _learning_rate(optim, kind))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_jax(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(STEPS):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tu, ts = topt.update(params_from_jax(grads), ts, tp)
        _leaves_close(tu, ju, OPT_TOL)
        jp, tp = jax_optim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
    _leaves_close(tp, jp, OPT_TOL)
    _leaves_close(ts, js, OPT_TOL)
    # a state crosses to the port as its counterpart NamedTuple
    assert type(params_from_jax(js)).__name__ == type(ts).__name__


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_update_dtypes_match_reference_on_a_mixed_tree(name):
    """bfloat16 weights and float32 norms: a float32 learning rate promotes, as in JAX."""
    jparams = {"w": jnp.ones((4, 4), jnp.bfloat16), "scale": jnp.ones((4,), jnp.float32)}
    tparams = params_from_jax(jparams)
    jopt, topt = OPTIMIZERS[name](jax_optim, 1e-2), OPTIMIZERS[name](optim, 1e-2)
    ju, _ = jopt.update(jax.tree_util.tree_map(jnp.ones_like, jparams), jopt.init(jparams),
                        jparams)
    tu, _ = topt.update({k: torch.ones_like(v) for k, v in tparams.items()},
                        topt.init(tparams), tparams)
    for k in ju:
        assert str(tu[k].dtype).replace("torch.", "") == str(ju[k].dtype)
        _close(tu[k], np.asarray(ju[k], np.float32), OPT_TOL)


def test_exports_follow_the_reference_order():
    assert optim.__all__[:len(jax_optim.__all__)] == jax_optim.__all__
    for name in optim.__all__:
        assert hasattr(optim, name)


# -------------------------------------------------------------- schedules

SCHEDULES = {
    "constant": (lambda s: s.constant(3e-4), [0, 1, 50, 100, 150]),
    "linear": (lambda s: s.linear_schedule(1.0, 0.1, 40), [0, 10, 20, 40, 60]),
    "warmup_cosine": (lambda s: s.linear_warmup_cosine_decay(1.0, 10, 100, end_value=0.1),
                      [0, 5, 10, 55, 100, 120]),
}


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name, as_tensor):
    make, steps = SCHEDULES[name]
    jsched, tsched = make(jax_optim), make(optim)
    for step in steps:
        jstep = jnp.asarray(step, jnp.int32) if as_tensor else step
        tstep = torch.tensor(step, dtype=torch.int32) if as_tensor else step
        got = tsched(tstep)
        assert got.dtype == torch.float32 and got.dim() == 0
        _close(got, jsched(jstep), SCHED_TOL)


# ------------------------------------------------------------------ layers


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["RMSNorm", "LayerNorm"])
def test_norms_match_reference(norm, dtype):
    rng = np.random.default_rng(1)
    jlayer, tlayer = getattr(jl, norm)(8), getattr(tl, norm)(8)
    jp = jlayer.init(jax.random.key(0))
    # moved off ones / zeros so that the scale and shift are exercised
    jp = jax.tree_util.tree_map(lambda v: v + jnp.asarray(_rand(rng, *v.shape)), jp)
    x = _rand(rng, 3, 5, 8) * 3 + 1
    jx = jnp.asarray(x).astype(dtype)
    got = tlayer.apply(params_from_jax(jp), params_from_jax(jx))
    want = jlayer.apply(jp, jx)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    _close(got, np.asarray(want, np.float32), LAYER_TOL)
    assert tlayer.axes() == jlayer.axes()
    init = tlayer.init(torch.Generator().manual_seed(0))
    _leaves_close(init, jlayer.init(jax.random.key(0)), 0.0)


def test_embed_lookup_and_attend_match_reference():
    rng = np.random.default_rng(2)
    jlayer, tlayer = jl.Embed(50, 8, logical_axes=("vocab", "embed")), tl.Embed(
        50, 8, logical_axes=("vocab", "embed"))
    jp = jlayer.init(jax.random.key(1))
    tp = params_from_jax(jp)
    ids = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    _close(tlayer.apply(tp, torch.from_numpy(ids)), jlayer.apply(jp, ids), LAYER_TOL)
    x = _rand(rng, 3, 8)
    _close(tlayer.attend(tp, torch.from_numpy(x)), jlayer.attend(jp, x), LAYER_TOL)
    assert tlayer.axes() == jlayer.axes()
    init = tlayer.init(torch.Generator().manual_seed(0))
    assert init["embedding"].shape == (50, 8) and init["embedding"].dtype == torch.float32


def test_sequential_matches_reference():
    rng = np.random.default_rng(3)
    jseq = jl.Sequential([jl.Dense(6, 16), jl.LayerNorm(16), jl.MLP((16, 8, 4)), jl.RMSNorm(4)])
    tseq = tl.Sequential([tl.Dense(6, 16), tl.LayerNorm(16), tl.MLP((16, 8, 4)), tl.RMSNorm(4)])
    jp = jseq.init(jax.random.key(2))
    x = _rand(rng, 5, 6) * 0.3
    _close(tseq.apply(params_from_jax(jp), torch.from_numpy(x)), jseq.apply(jp, x), LAYER_TOL)
    assert tseq.axes() == jseq.axes()
    # the port's init gives the reference's tree: keys, shapes and dtypes
    tinit = tseq.init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(params_to_jax(tinit)) == \
        jax.tree_util.tree_structure(jp)
    for t, j in zip(tree_leaves(tinit), jax.tree_util.tree_leaves(jp)):
        assert tuple(t.shape) == j.shape and str(t.dtype).replace("torch.", "") == str(j.dtype)
    cell_t, cell_j = tl.GRUCell(3, 4), jl.GRUCell(3, 4)
    assert cell_t.axes() == cell_j.axes()
    assert tl.Dense(3, 4, use_bias=False).axes() == jl.Dense(3, 4, use_bias=False).axes()


# ------------------------------------------------------------- initializers

SHAPE = (256, 512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_constant_initializers(dtype):
    g = torch.Generator().manual_seed(0)
    for init, value in ((initializers.zeros, 0.0), (initializers.ones, 1.0)):
        x = init(g, (3, 4), dtype)
        assert x.shape == (3, 4) and x.dtype == dtype and bool((x == value).all())


@pytest.mark.parametrize("name", ["normal", "truncated_normal"])
def test_random_initializers_by_shape_dtype_and_moments(name):
    stddev = 0.5
    t = getattr(initializers, name)(stddev)(torch.Generator().manual_seed(0), SHAPE)
    j = np.asarray(getattr(jax_init, name)(stddev)(jax.random.key(0), SHAPE))
    assert t.shape == SHAPE and t.dtype == torch.float32
    assert getattr(initializers, name)(stddev)(torch.Generator().manual_seed(0), (4,),
                                                torch.bfloat16).dtype == torch.bfloat16
    t = t.numpy()
    # the same distribution as the reference's draw: 131,072 samples put the
    # mean within ~3.5 standard errors (0.005) and the spread within ~1%
    assert abs(t.mean()) < 0.005 and abs(j.mean()) < 0.005
    assert abs(t.std() - j.std()) < 0.01 * stddev
    if name == "truncated_normal":
        assert np.abs(t).max() <= 2 * stddev and np.abs(j).max() <= 2 * stddev
        # a unit normal cut at +-2 has standard deviation 0.8796
        assert abs(t.std() - 0.8796 * stddev) < 0.01 * stddev
    else:
        assert abs(t.std() - stddev) < 0.01 * stddev
        assert np.abs(t).max() > 2 * stddev  # not truncated


# --------------------------------------------------------------------- data


def test_trajectory_helpers_match_reference():
    rng = np.random.default_rng(4)
    trajs = [{"obs": {"agent_0": _rand(rng, 3, 2)}, "reward": _rand(rng, 3),
              "done": rng.random(3) < 0.5} for _ in range(4)]
    want = jax_traj.batch_trajectories(trajs)
    for as_tensor in (False, True):
        given = [{"obs": {"agent_0": torch.from_numpy(t["obs"]["agent_0"])},
                  "reward": torch.from_numpy(t["reward"]), "done": torch.from_numpy(t["done"])}
                 for t in trajs] if as_tensor else trajs
        got = batch_trajectories(given)
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    rewards, dones = _rand(rng, 40), rng.random(40) < 0.2
    np.testing.assert_array_equal(episode_returns(rewards, dones),
                                  jax_traj.episode_returns(rewards, dones))


def _host_batch():
    ds = jax_tokens.SyntheticTokenDataset(97, 16, 4, seed=3)
    return ds.sample(np.random.default_rng(5))


def test_make_lm_batch_on_a_device_matches_reference():
    host = _host_batch()
    got, want = make_lm_batch(host, device="cpu"), jax_tokens.make_lm_batch(host)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_make_lm_batch_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_lm_batch(_host_batch())


def _mesh_batch(rank, world_size, device):
    """On a 1-rank ("data",) mesh: the batch as DTensors laid out by the batch sharding."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import NamedSharding

    mesh = init_device_mesh("cpu", (world_size,), mesh_dim_names=("data",))
    got = make_lm_batch(_host_batch(), NamedSharding(mesh, ("data",)))
    return {k: (type(v).__name__, tuple((type(p).__name__, getattr(p, "dim", None))
                                         for p in v.placements), v.full_tensor())
            for k, v in got.items()}


def test_make_lm_batch_under_a_mesh_matches_reference():
    (got,) = collective.run_world(_mesh_batch, 1, "gloo", "cpu", timeout_s=120.0)
    want = jax_tokens.make_lm_batch(_host_batch())
    for k in want:
        kind, placements, full = got[k]
        assert kind == "DTensor" and placements == (("Shard", 0),)
        assert full.dtype == torch.int32
        np.testing.assert_array_equal(full.numpy(), np.asarray(want[k]))


# ------------------------------------------------------------------- envs


def test_shared_reward_broadcasts_one_value_as_the_reference():
    ids = api.agent_ids(3)
    value = torch.tensor([1.0, -2.0])
    got = api.shared_reward(ids, value)
    want = jax_api.shared_reward(jax_api.agent_ids(3), jnp.asarray([1.0, -2.0]))
    assert list(got) == list(want)
    assert all(got[a] is value for a in ids)
    ts = api.transition(ids, value, {"agent_0": torch.zeros(2, 1)}, torch.tensor([False, True]))
    assert all(ts.reward[a] is value for a in ids)
    first = api.restart(ids, {"agent_0": torch.zeros(2, 1)})
    assert all(torch.equal(first.reward[a], torch.zeros(2)) for a in ids)
