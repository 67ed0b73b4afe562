"""MoE serving: the port against the JAX package, on the CPU.

* ``expert_capacity``;
* ``top_k_routing``'s dispatch, combine, aux and z losses against JAX, with
  capacity factors that force drops and one that drops nothing;
* ``moe_ffn`` with a token count that is not a multiple of the group size
  (the padded tail), and in the decode regime (E = 64, top-8, 4 tokens, so
  C = 1) at narrow width;
* on the ``olmoe-1b-7b`` smoke config, with the weights of
  ``repro.models.model.init_model(jax.random.key(0), cfg)`` converted
  across: config, parameter counts and init (names, shapes, dtypes);
  ``prefill`` then 4 ``decode_step`` calls, logits at 1e-4 and cache leaves
  at 1e-5.

The router logits are random normals, so no two experts of a real token
tie: with ties, ``torch.topk`` and ``lax.top_k`` may order equal experts
differently.  The zero rows that pad a group's tail do tie on every expert;
the port breaks those ties by index, as ``lax.top_k`` does, and the
padded-tail case holds it to that.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_cache_to_jax,
    lm_params_from_jax,
    lm_params_to_jax,
    params_from_jax,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402

ARCH = "olmoe-1b-7b"
TOL = 1e-5
LOGIT_TOL = 1e-4


@functools.cache
def _models(dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port model) on the smoke config."""
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    params = jax.jit(JM.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    return jcfg, params, tcfg, lm_params_from_jax(params, tcfg)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def _narrow(E, k, group, factor, d=16, ff=8):
    """A narrow MoE config of both packages, and the JAX init of one layer's FFN."""
    fields = dict(name="moe-narrow", arch_type="moe", num_layers=1, d_model=d, num_heads=2,
                  num_kv_heads=2, d_ff=ff, vocab=32, num_experts=E, top_k=k,
                  capacity_factor=factor, moe_group_size=group, dtype="float32")
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), **fields)
    params = jax.jit(lambda key: JMoE.init_moe(key, jcfg)[0])(jax.random.key(E + k))
    return jcfg, ModelConfig(**fields), params


_jax_moe_ffn = jax.jit(JMoE.moe_ffn, static_argnums=2)


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("g,E,k,factor", [(512, 64, 8, 1.25), (4, 64, 8, 1.25), (64, 4, 2, 2.0),
                                          (16, 8, 2, 0.5), (7, 3, 1, 1.0)])
def test_expert_capacity(g, E, k, factor):
    assert TMoE.expert_capacity(g, E, k, factor) == JMoE.expert_capacity(g, E, k, factor)
    if (g, E, k) == (512, 64, 8):
        assert TMoE.expert_capacity(g, E, k, factor) == 80  # OLMoE at prefill
    if (g, E, k) == (4, 64, 8):
        assert TMoE.expert_capacity(g, E, k, factor) == 1  # OLMoE decoding 4 streams


@pytest.mark.parametrize("factor,drops", [(0.5, True), (1.0, True), (4.0, False)])
def test_top_k_routing_against_jax(factor, drops):
    G, g, E, k = 3, 16, 8, 3
    logits = np.random.default_rng(7).normal(size=(G, g, E)).astype(np.float32) * 2
    C = JMoE.expert_capacity(g, E, k, factor)
    jd, jc, jaux, jz = jax.jit(JMoE.top_k_routing, static_argnums=(1, 2))(
        jnp.asarray(logits), k, C)
    d, c, aux, z = TMoE.top_k_routing(torch.from_numpy(logits), k, C)
    assert d.dtype == torch.bool and c.dtype == torch.float32
    assert d.shape == c.shape == (G, g, E, C)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    _close(c, jc, 1e-6)
    _close(aux, jaux, 1e-6)
    _close(z, jz, 1e-6)
    kept = int(d.sum())
    assert (kept < G * g * k) == drops
    # each kept pair in one slot of its expert, each slot at most one token
    assert bool((d.sum(dim=1) <= 1).all())
    assert bool((d.sum(dim=(2, 3)) <= k).all())


# ---------------------------------------------------------------- moe_ffn


@pytest.mark.parametrize("group", [8, 64])
def test_moe_ffn_with_a_padded_tail(group):
    """21 tokens in groups of 8 (a tail of 5, padded by 3) and in one group of 21."""
    jcfg, tcfg, params = _narrow(E=4, k=2, group=group, factor=1.0)
    x = np.random.default_rng(8).normal(size=(3, 7, tcfg.d_model)).astype(np.float32)
    jy, jaux, jz = _jax_moe_ffn(params, jnp.asarray(x), jcfg)
    y, aux, z = TMoE.moe_ffn(Params(params_from_jax(params)), torch.from_numpy(x), tcfg)
    assert y.shape == x.shape
    _close(y, jy)
    _close(aux, jaux)
    _close(z, jz)


def test_moe_ffn_in_the_decode_regime():
    """E = 64, top-8, 4 tokens: C = 1, so streams routed to one expert drop."""
    jcfg, tcfg, params = _narrow(E=64, k=8, group=512, factor=1.25)
    x = np.random.default_rng(9).normal(size=(4, 1, tcfg.d_model)).astype(np.float32)
    jy, _, _ = _jax_moe_ffn(params, jnp.asarray(x), jcfg)
    p = Params(params_from_jax(params))
    y, _, _ = TMoE.moe_ffn(p, torch.from_numpy(x), tcfg)
    _close(y, jy)
    logits = torch.from_numpy(x).reshape(1, 4, -1) @ p.router
    dispatch, _, _, _ = TMoE.top_k_routing(logits, 8, 1)
    assert dispatch.shape == (1, 4, 64, 1) and int(dispatch.sum()) < 4 * 8


# ----------------------------------------------------- olmoe smoke config


def test_olmoe_config_and_init_match_the_reference():
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    assert get_config(ARCH).param_count() == 6_919_094_272
    assert get_config(ARCH).active_param_count() == 1_281_949_696
    assert get_config(ARCH).moe_d_ff == 1024  # 0 -> d_ff

    for dtype in ("float32", "bfloat16"):
        _, params, tcfg, model = _models(dtype)
        got = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), lm_params_to_jax(
            TM.init_model(torch.Generator().manual_seed(0), tcfg)))
        want = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), params)
        assert got == want
        assert not any(p.requires_grad for p in model.parameters())  # moe serves only
    _, _, tcfg, model = _models()
    with pytest.raises(NotImplementedError, match="training of the 'moe' family"):
        TM.forward_train(model, {"tokens": torch.zeros(1, 4, dtype=torch.long),
                                 "labels": torch.zeros(1, 4, dtype=torch.long)})


def test_olmoe_prefill_and_decode_against_jax():
    jcfg, params, tcfg, model = _models()
    B, S, steps = 2, 40, 4  # 80 tokens: one group of 64 and a padded tail
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, b: JM.prefill(p, b, jcfg, max_len=S + steps))(
        params, {"tokens": jnp.asarray(tokens)})
    logits, cache = TM.prefill(model, torch.from_numpy(tokens), max_len=S + steps)
    _close(logits, jlogits, LOGIT_TOL)

    def close_cache(cache, jcache):
        got = lm_cache_to_jax(cache)
        np.testing.assert_array_equal(got["pos"], np.asarray(jcache["pos"]))
        for name in ("k", "v"):
            _close(got["kv"][name], jcache["kv"][name])

    close_cache(cache, jcache)
    jdecode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg))
    tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    for _ in range(steps):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        logits, cache = TM.decode_step(model, cache, torch.from_numpy(tok))
        _close(logits, jlogits, LOGIT_TOL)
        close_cache(cache, jcache)
        tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
