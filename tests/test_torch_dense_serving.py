"""Dense serving: the port against the JAX package, on the CPU.

On the smoke configs of ``internlm2-1.8b``, ``granite-8b`` and
``minitron-8b`` (whose smoke config has a window of 64), with the weights
of ``repro.models.model.init_model(jax.random.key(0), cfg)`` converted
across:

* configs and the registry: the same field values and parameter counts as
  the reference;
* ``init_kv_cache`` and ``place_kv_in_cache`` for C >= S and C < S (a ring);
* ``attention_decode`` at per-stream positions, windowed and not: the
  output and the cache it writes in place;
* ``prefill`` then 4 ``decode_step`` calls: logits at 1e-4 and every cache
  leaf at 1e-5, with the prompt longer than minitron's window; a bfloat16
  granite model at 2e-2;
* the reference's own oracle (tests/test_prefill_decode.py): prefill and
  one decode step equal the full forward at 2e-4 / 2e-3, and its ring-cache
  case (S = 40, window 16).
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
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_cache_from_jax,
    lm_cache_to_jax,
    lm_params_from_jax,
)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

DENSE = ("internlm2-1.8b", "granite-8b", "minitron-8b")
CACHE_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 2e-2


@functools.cache
def _models(arch, dtype="float32", **changes):
    """(JAX cfg, JAX params, port cfg, port model) on ``arch``'s smoke config."""
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype=dtype, **changes)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **changes)
    params = jax.jit(JM.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    return jcfg, params, tcfg, lm_params_from_jax(params, tcfg)


@functools.cache
def _jax_fns(jcfg, max_len):
    prefill = jax.jit(lambda p, b: JM.prefill(p, b, jcfg, max_len=max_len))
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg))
    return prefill, decode


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def _close_caches(cache, jcache, tol=CACHE_TOL):
    got, want = lm_cache_to_jax(cache), jcache
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype)
        _close(np.asarray(g, np.float32), w, tol)


def _full_logits(model, tokens):
    """The port's training forward over whole sequences: (B,S,V) logits."""
    h, _ = TM._run_layers_train(model, TM._embed_tokens(model, tokens))
    return TM._logits(model, h)


# ----------------------------------------------------------- configs


@pytest.mark.parametrize("arch", DENSE)
def test_configs_and_registry_match_the_reference(arch):
    assert arch in ARCH_IDS
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_get_smoke_config(arch))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    for arch_id in ("llama3-405b", "kimi-k2-1t-a32b"):  # they shard over a mesh
        with pytest.raises(NotImplementedError, match=arch_id):
            get_config(arch_id)


def test_published_sizes():
    assert get_config("granite-8b").param_count() == 8_254_685_184
    assert get_config("minitron-8b").param_count() == 9_882_042_368
    assert TM.PORTED == {fam: ("training", "serving") for fam in
                         ("dense", "moe", "mamba1", "hybrid", "vlm", "audio")}


# ------------------------------------------------------------- the cache


@pytest.mark.parametrize("S,C", [(5, 9), (9, 9), (13, 5), (10, 5)])  # C >= S and C < S
def test_place_kv_in_cache(S, C):
    k = np.random.default_rng(S * C).normal(size=(2, S, 3, 4)).astype(np.float32)
    got = TA.place_kv_in_cache(torch.from_numpy(k), C)
    _close(got, JA.place_kv_in_cache(jnp.asarray(k), C), 0.0)
    assert got.shape == (2, C, 3, 4)


@pytest.mark.parametrize("window,max_len,C", [(0, 24, 24), (16, 24, 16), (64, 24, 24)])
def test_init_kv_cache(window, max_len, C):
    _, _, tcfg, _ = _models("granite-8b")
    cfg = dataclasses.replace(tcfg, attn_window=window)
    cache = TA.init_kv_cache(cfg, 3, max_len, "cpu")
    assert set(cache) == {"k", "v"}
    for t in cache.values():
        assert t.shape == (cfg.num_layers, 3, C, cfg.num_kv_heads, cfg.head_dim)
        assert t.dtype == torch.float32 and not t.any()
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    assert TA.init_kv_cache(bf16, 1, 8, "cpu")["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("window", [0, 8])
def test_attention_decode_at_per_stream_positions(window):
    """Streams at positions 3 and 17: unwindowed C = 24, or a ring of C = 8."""
    jcfg, params, tcfg, model = _models("granite-8b")
    jcfg = dataclasses.replace(jcfg, attn_window=window)
    tcfg = dataclasses.replace(tcfg, attn_window=window)
    C = window or 24
    rng = np.random.default_rng(window)
    shape = (2, C, tcfg.num_kv_heads, tcfg.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([3, 17], np.int32)
    p0 = jax.tree_util.tree_map(lambda a: a[0], params["layers"])["attn"]

    jy, jcache = jax.jit(lambda p, x, c, pos: JA.attention_decode(p, x, c, pos, jcfg))(
        p0, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    before = {n: t.clone() for n, t in cache.items()}
    y, out = TA.attention_decode(model.layers[0].attn, torch.from_numpy(x), cache,
                                 torch.from_numpy(pos), tcfg)
    assert y.shape == (2, 1, tcfg.d_model)
    _close(y, jy, CACHE_TOL)
    for name in ("k", "v"):
        assert out[name] is cache[name]  # written in place
        _close(out[name], jcache[name], CACHE_TOL)
        changed = (out[name] != before[name]).any(dim=(2, 3))
        slots = [3, 17 % C] if window else [3, 17]
        assert changed.nonzero().tolist() == [[0, slots[0]], [1, slots[1]]]


# ------------------------------------------------------ prefill, decode


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_steps_against_jax(arch):
    """A prompt of 70 (past minitron's window of 64), then 4 greedy steps."""
    jcfg, params, tcfg, model = _models(arch)
    B, S, steps = 2, 70, 4
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    jprefill, jdecode = _jax_fns(jcfg, S + steps)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(tokens)})
    logits, cache = TM.prefill(model, torch.from_numpy(tokens), max_len=S + steps)
    assert logits.shape == (B, 1, tcfg.vocab)
    C = min(S + steps, tcfg.attn_window or S + steps)
    assert cache["kv"]["k"].shape == (tcfg.num_layers, B, C, tcfg.num_kv_heads, tcfg.head_dim)
    _close(logits, jlogits, LOGIT_TOL)
    _close_caches(cache, jcache)
    assert cache["pos"].dtype == torch.int32

    tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    for _ in range(steps):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        pos = cache["pos"].clone()
        logits, new = TM.decode_step(model, cache, torch.from_numpy(tok))
        _close(logits, jlogits, LOGIT_TOL)
        _close_caches(new, jcache)
        assert new["kv"]["k"] is cache["kv"]["k"]  # the K/V are written in place
        assert torch.equal(cache["pos"], pos)  # pos advances in a new tensor
        cache = new
        tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    back = lm_cache_from_jax(jcache)  # the JAX cache crosses leaf by leaf
    assert back["pos"].dtype == torch.int32 and torch.equal(back["pos"], cache["pos"])
    assert [t.shape for t in tree_leaves(back)] == [t.shape for t in tree_leaves(cache)]
    with pytest.raises(ValueError):
        lm_cache_to_jax({"k": torch.zeros(1)})


def test_bfloat16_granite_prefill_and_decode():
    """A bf16 model: a cast in the wrong place moves the logits by far more than 2e-2."""
    jcfg, params, tcfg, model = _models("granite-8b", "bfloat16")
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 21)).astype(np.int32)
    jprefill, jdecode = _jax_fns(jcfg, 24)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(tokens)})
    logits, cache = TM.prefill(model, torch.from_numpy(tokens), max_len=24)
    assert logits.dtype == cache["kv"]["k"].dtype == torch.bfloat16
    _close(logits, jlogits, BF16_TOL)
    _close_caches(cache, jcache, BF16_TOL)
    tok = np.argmax(np.asarray(jlogits, np.float32), -1).astype(np.int32)
    jl2, _ = jdecode(params, jcache, jnp.asarray(tok))
    l2, _ = TM.decode_step(model, cache, torch.from_numpy(tok))
    _close(l2, jl2, BF16_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_full_forward(arch):
    """tests/test_prefill_decode.py:22 on the port: 2e-4 for prefill, 2e-3 for decode."""
    _, _, tcfg, model = _models(arch)
    B, S = 2, 32
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab, (B, S + 1)))
    last, cache = TM.prefill(model, toks[:, :S], max_len=S + 4)
    with torch.no_grad():
        full = _full_logits(model, toks)
    torch.testing.assert_close(last[:, -1], full[:, S - 1], rtol=2e-4, atol=2e-4)
    dec, cache2 = TM.decode_step(model, cache, toks[:, S:])
    assert bool((cache2["pos"] == S + 1).all())
    torch.testing.assert_close(dec[:, 0], full[:, S], rtol=2e-3, atol=2e-3)


def test_sliding_window_ring_cache_drops_old_tokens():
    """tests/test_prefill_decode.py:62 on the port: S = 40, window 16."""
    _, _, tcfg, model = _models("minitron-8b", attn_window=16)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab, (1, 41)))
    _, cache = TM.prefill(model, toks[:, :40], max_len=44)
    assert cache["kv"]["k"].shape[2] == 16  # the window's capacity, not the prompt's
    dec, _ = TM.decode_step(model, cache, toks[:, 40:])
    with torch.no_grad():
        full = _full_logits(model, toks)  # the windowed oracle
    torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=2e-3, atol=2e-3)


def test_decode_runs_no_autograd_and_keeps_weights_trainable():
    _, _, tcfg, model = _models("internlm2-1.8b")
    assert all(p.requires_grad for p in model.parameters())  # dense still trains
    logits, cache = TM.prefill(model, torch.zeros(1, 5, dtype=torch.long), max_len=6)
    assert not logits.requires_grad and not cache["kv"]["k"].requires_grad
