"""Logical-axis sharding of the port against the JAX package's.

* The reference's `tests/test_sharding.py` cases against
  `repro_torch.distributed.sharding` (divisibility dropping, profiles,
  the ambient mesh, `with_logical_constraint` untouched off a mesh).
* For all ten archs at published width on the production meshes (16, 16)
  and (2, 16, 16): every parameter's spec under the config's profile
  equals ``repro.distributed.sharding.logical_to_spec`` on a device-free
  ``jax.sharding.AbstractMesh`` of the reference's axes and stacked
  shapes, and the summed local parameter bytes a device equal the
  reference's (Llama-3.1-405B 3.67 of 811.7 GB, Kimi-K2 8.27 of 2,082.7
  GB), as do the AdamW state's and, under ``shard_kv_seq``, the decode
  cache's at decode_32k.  No process group is needed: the port's
  `AbstractMesh` carries names and sizes only.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    DEFAULT_RULES,
    FSDP_TP_RULES,
    AbstractMesh,
    enter_mesh,
    logical_to_spec,
    rules_for,
    tree_shardings,
    with_logical_constraint,
)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# summed local parameter bytes a device on either mesh (the pod axis shards only the batch)
PUBLISHED_GB = {"llama3-405b": (3.67, 811.7), "kimi-k2-1t-a32b": (8.27, 2082.7),
                "minitron-8b": (1.74, 19.8), "internlm2-1.8b": (0.43, 3.8)}


def make_mesh():
    return AbstractMesh((2, 4), ("data", "model"))


# ------------------------------------------------ the reference's cases


def test_basic_mapping():
    assert logical_to_spec(("vocab", "embed"), DEFAULT_RULES, make_mesh()) == ("model",)


def test_batch_uses_pod_and_data():
    mesh = AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    assert logical_to_spec(("batch", None, "embed"), DEFAULT_RULES, mesh) == (("pod", "data"),)


def test_non_divisible_axis_dropped():
    mesh = make_mesh()
    assert logical_to_spec(("kv_heads",), DEFAULT_RULES, mesh, shape=(8,)) == ("model",)
    assert logical_to_spec(("kv_heads",), DEFAULT_RULES, mesh, shape=(6,)) == ()


def test_axis_never_reused_within_spec():
    assert logical_to_spec(("vocab", "ffn"), DEFAULT_RULES, make_mesh()) == ("model",)


def test_fsdp_profile_shards_embed_over_data():
    mesh = make_mesh()
    assert logical_to_spec(("embed", "ffn"), FSDP_TP_RULES, mesh, shape=(8, 8)) == ("data", "model")
    # but activations with a batch dim keep data for the batch
    assert logical_to_spec(("batch", None, "embed"), FSDP_TP_RULES, mesh, shape=(8, 4, 8)) == (
        "data",)


def test_tree_shardings_with_shapes():
    axes = {"w": ("embed", "ffn"), "b": ("ffn",)}
    shapes = {"w": torch.empty(16, 8, device="meta"), "b": torch.empty(6, device="meta")}
    out = tree_shardings(axes, make_mesh(), DEFAULT_RULES, shapes)
    assert out["w"].spec == (None, "model")
    assert out["b"].spec == ()


def test_unknown_profile_raises():
    with pytest.raises(KeyError):
        rules_for("nope")


def test_actors_axis_rule_maps_to_data():
    assert logical_to_spec(("actors",), DEFAULT_RULES, make_mesh()) == ("data",)


def test_enter_mesh_installs_ambient_mesh():
    assert sh.ambient_mesh() is None
    mesh = make_mesh()
    with enter_mesh(mesh):
        assert sh.ambient_mesh() is mesh
    assert sh.ambient_mesh() is None


def test_with_logical_constraint_is_noop_outside_mesh():
    x = torch.arange(8.0)
    assert with_logical_constraint(x, ("batch",)) is x  # literally untouched


def test_placements_split_a_dim_major_first():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    spec = logical_to_spec(("batch", "vocab"), DEFAULT_RULES, mesh, shape=(8, 16))
    assert sh.placements(spec, mesh) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements((), mesh) == (Replicate(),) * 3


# ------------------------------------- published widths against JAX's specs


def jax_mesh(name):
    sizes, names = MESHES[name]
    if hasattr(jax.sharding, "AxisType"):
        return jax.sharding.AbstractMesh(sizes, names,
                                         axis_types=(jax.sharding.AxisType.Auto,) * len(names))
    return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def _jax_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _nbytes(shape, dtype):
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


@pytest.fixture(scope="module")
def jax_params():
    """Each arch's JAX parameter shapes (stacked) and logical axes."""
    out = {}
    for arch in ARCH_IDS:
        cfg = jax_get_config(arch)
        shapes = jax.eval_shape(lambda k, c=cfg: JM.init_model(k, c), jax.random.key(0))
        out[arch] = (shapes, JM.model_axes(cfg))
    return out


@pytest.fixture(scope="module")
def port_params():
    return {arch: steps.param_shapes(get_config(arch)) for arch in ARCH_IDS}


def _jax_spec_of(jaxes, jshapes, path, rules, mesh):
    """The reference's spec of the port leaf at ``path`` (``layers`` unstacked)."""
    if path[0] == "layers":
        jpath = ("layers",) + path[2:]
        ax = _jax_leaf(jaxes, jpath)
        spec = tuple(jsh.logical_to_spec(ax, rules, mesh, shape=_jax_leaf(jshapes, jpath).shape))
        assert not spec or spec[0] is None  # the stacked layer dim is never sharded
        return spec[1:]
    return tuple(jsh.logical_to_spec(_jax_leaf(jaxes, path), rules, mesh,
                                     shape=_jax_leaf(jshapes, path).shape))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_specs_and_bytes_equal_the_reference(arch, mesh_name, jax_params,
                                                       port_params):
    cfg = get_config(arch)
    assert cfg.sharding == jax_get_config(arch).sharding
    jshapes, jaxes = jax_params[arch]
    jmesh, tmesh = jax_mesh(mesh_name), AbstractMesh(*MESHES[mesh_name])
    rules = rules_for(cfg.sharding)
    port_axes = dict(_leaves(M.model_axes(cfg)))
    local = total = opt_local = 0
    for path, t in _leaves(port_params[arch]):
        spec = logical_to_spec(port_axes[path], rules, tmesh, shape=t.shape)
        assert spec == _jax_spec_of(jaxes, jshapes, path, jsh.rules_for(cfg.sharding), jmesh), path
        shard = sh.local_shape(t.shape, spec, tmesh)
        local += _nbytes(shard, t.dtype)
        total += _nbytes(t.shape, t.dtype)
        opt_local += _nbytes(shard, t.dtype) + _nbytes(shard, torch.float32)  # mu, nu
    ref_total = sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(jshapes))
    assert total == ref_total
    if arch in PUBLISHED_GB:
        assert (round(local / 1e9, 2), round(total / 1e9, 1)) == PUBLISHED_GB[arch]

    # the AdamW state: every moment laid out as its parameter, the count replicated
    opt = steps.make_optimizer(cfg)
    state = opt.init(port_params[arch])
    moments = {path: t for path, t in _leaves([state[1].mu, state[1].nu])}
    got = 4 * state[1].count.numel()
    for (_, *path), t in moments.items():
        spec = logical_to_spec(port_axes[tuple(path)], rules, tmesh, shape=t.shape)
        got += _nbytes(sh.local_shape(t.shape, spec, tmesh), t.dtype)
    assert got == opt_local + 4


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sequence_sharded_cache_equals_the_reference(arch, mesh_name):
    """decode_32k's cache under ``shard_kv_seq``: specs and bytes a device."""
    from repro.models.config import get_input_shape as jax_shape

    cfg = dataclasses.replace(get_config(arch), shard_kv_seq=True)
    jcfg = dataclasses.replace(jax_get_config(arch), shard_kv_seq=True)
    shape = jax_shape("decode_32k")
    jmesh, tmesh = jax_mesh(mesh_name), AbstractMesh(*MESHES[mesh_name])
    jshapes = jax.eval_shape(lambda: JM.init_cache(jcfg, shape.global_batch, shape.seq_len))
    jaxes = JM.cache_axes(jcfg)
    port_axes = dict(_leaves(M.cache_axes(cfg)))
    with steps._OnMeta():
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, "cpu")
    rules = rules_for(cfg.sharding)
    local = ref_local = 0
    for path, t in _leaves(cache):
        spec = logical_to_spec(port_axes[path], rules, tmesh, shape=t.shape)
        jx = _jax_leaf(jshapes, path)
        jspec = tuple(jsh.logical_to_spec(_jax_leaf(jaxes, path), jsh.rules_for(cfg.sharding),
                                          jmesh, shape=jx.shape))
        assert tuple(t.shape) == tuple(jx.shape) and spec == jspec, path
        local += _nbytes(sh.local_shape(t.shape, spec, tmesh), t.dtype)
        ref_local += _nbytes(sh.local_shape(jx.shape, jspec, tmesh), t.dtype)
    assert local == ref_local
