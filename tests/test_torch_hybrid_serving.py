"""Zamba2 (the mamba2 hybrid) serving: the port against the JAX package, on the CPU.

On the ``zamba2-2.7b`` smoke config (4 mamba2 layers, the shared attention
block after every 2, a window of 32, SSD chunks of 16), with the weights of
``repro.models.model.init_model(jax.random.key(0), cfg)`` converted across:

* the config, the registry, ``param_count`` and ``flops_param_count``, and
  the port's own init (the JAX names, shapes and dtypes);
* ``ssd_chunked`` at S a multiple of the chunk, not a multiple (the dt = 0
  padding) and under one chunk, float32 at 1e-5 and bfloat16 at 2e-2; and
  against a step-by-step recurrence where the reference's unmasked decay
  overflows;
* ``mamba2_forward`` and ``mamba2_decode`` (outputs and both states);
* ``prefill`` with a prompt longer than the window, then 4 ``decode_step``
  calls: logits at 1e-4 and every cache leaf (conv, ssm, the shared block's
  K/V a slot, pos) at 1e-5, float32; a bfloat16 model's logits within 2e-2
  of their scale, and every leaf as close to the float32 model as the
  reference's bf16 one;
* a prefill of S tokens and one decode step = a prefill of S + 1 tokens;
* the serving engine token for token against ``repro.serving.engine`` and
  sequential generation, with prompts longer than a chunk and the window;
* the launcher's ``main`` and its greedy tokens against JAX.
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
from repro.models import ssm as JS  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_cache_from_jax,
    lm_cache_to_jax,
    lm_params_from_jax,
    lm_params_to_jax,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "zamba2-2.7b"
CACHE_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 2e-2


@functools.cache
def _models(dtype="float32", **changes):
    """(JAX cfg, JAX params, port cfg, port model) on the smoke config."""
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), dtype=dtype, **changes)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **changes)
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
    got = lm_cache_to_jax(cache)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jcache)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jcache)):
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype)
        _close(np.asarray(g, np.float32), w, tol)


def _layer0_mamba(params):
    return jax.tree_util.tree_map(lambda x: x[0], params["layers"])["mamba"]


# ----------------------------------------------------------- config, init


def test_config_registry_and_counts_match_the_reference():
    assert ARCH in ARCH_IDS
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.param_count() == ref.param_count()
        assert port.flops_param_count() == ref.flops_param_count()
        assert (port.ssm_heads, port.num_attn_invocations) == (ref.ssm_heads,
                                                               ref.num_attn_invocations)
    cfg = get_config(ARCH)
    assert (cfg.ssm_heads, cfg.num_attn_invocations, cfg.head_dim) == (80, 9, 80)
    assert cfg.param_count() == 2_422_103_488
    # the shared block counts once a parameter, once an invocation as compute
    assert cfg.flops_param_count() - cfg.param_count() == 8 * cfg._shared_block_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_the_reference_layout(dtype):
    _, params, tcfg, model = _models(dtype)
    own = TM.init_model(torch.Generator().manual_seed(0), tcfg)
    shapes = lambda tree: jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), tree)
    assert shapes(lm_params_to_jax(own)) == shapes(params)
    assert shapes(lm_params_to_jax(model)) == shapes(params)
    m = own.layers[0].mamba
    assert isinstance(m, TS.Mamba2) and not m.conv_b.any()
    assert torch.equal(m.D, torch.ones_like(m.D))
    assert bool(((m.A_log.exp() >= 1) & (m.A_log.exp() < 16)).all())
    dt = torch.nn.functional.softplus(m.dt_bias)
    assert bool(((dt > 0.99e-3) & (dt < 1.01e-1)).all())
    assert all(p.requires_grad for p in own.parameters())  # served and trained
    # per layer: the norm and eight mamba2 leaves; the shared block's 9; embed,
    # unembed, final norm
    assert len(tree_leaves(own.tree())) == tcfg.num_layers * 9 + 9 + 3


# -------------------------------------------------------------------- SSD


def _ssd_inputs(S, dtype, h=3, p=4, n=5, dt_scale=0.5, seed=0):
    """Decays within float32's exp range a chunk at dt_scale 0.5; past it at 40."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S, h, p)).astype(np.float32)
    dt = (dt_scale * np.log1p(np.exp(rng.normal(size=(2, S, h))))).astype(np.float32)
    A = -np.exp(rng.uniform(-1.0, 0.5, size=(h,))).astype(np.float32)
    B, C = (rng.normal(size=(2, S, n)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(h,)).astype(np.float32)
    cast = {"float32": np.float32, "bfloat16": jnp.bfloat16}[dtype]
    return x.astype(cast), dt, A, B.astype(cast), C.astype(cast), D


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 40, 11])  # a chunk multiple, a padded tail, under one chunk
def test_ssd_chunked_against_jax(S, dtype):
    args = _ssd_inputs(S, dtype)
    jy, jstate = jax.jit(JS.ssd_chunked, static_argnums=6)(*map(jnp.asarray, args), 16)
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
    t[0], t[3], t[4] = (u.to(torch.bfloat16) if dtype == "bfloat16" else u
                        for u in (t[0], t[3], t[4]))
    y, state = TS.ssd_chunked(*t, 16)
    assert y.dtype == t[0].dtype and state.dtype == torch.float32
    assert y.shape == (2, S, 3, 4) and state.shape == (2, 3, 5, 4)
    tol = BF16_TOL if dtype == "bfloat16" else CACHE_TOL
    _close(y, jy, tol)
    _close(state, jstate, CACHE_TOL)


def test_ssd_chunked_where_the_reference_decay_overflows():
    """Large dt: the reference's exp(cum_i - cum_j) above the diagonal passes
    float32's range and inf * 0 gives NaN; the port masks the exponent first
    and equals the step-by-step recurrence."""
    x, dt, A, B, C, D = _ssd_inputs(48, "float32", dt_scale=40.0, seed=1)
    jy, _ = jax.jit(JS.ssd_chunked, static_argnums=6)(*map(jnp.asarray, (x, dt, A, B, C, D)), 16)
    assert np.isnan(np.asarray(jy)).any()
    y, state = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C, D)), 16)
    h = np.zeros((2, 3, 5, 4))
    want = np.zeros_like(x, dtype=np.float64)
    for s in range(48):  # h_s = exp(dt A) h + dt B x; y_s = C h_s + D x
        h = np.exp(dt[:, s, :, None, None] * A[:, None, None]) * h + np.einsum(
            "bn,bhp->bhnp", B[:, s], x[:, s] * dt[:, s, :, None])
        want[:, s] = np.einsum("bn,bhnp->bhp", C[:, s], h) + D[:, None] * x[:, s]
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), h, atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------------- mamba2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_and_decode(dtype):
    jcfg, params, tcfg, model = _models(dtype)
    tol = BF16_TOL if dtype == "bfloat16" else CACHE_TOL
    x = np.random.default_rng(1).normal(size=(2, 37, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.activation_dtype)
    tx = torch.from_numpy(x).to(tcfg.activation_dtype)
    p0, m0 = _layer0_mamba(params), model.layers[0].mamba

    y, (conv, ssm) = m0(tx)
    jy, (jconv, jssm) = jax.jit(lambda p, x: JS.mamba2_forward(p, x, jcfg))(p0, jx)
    assert y.dtype == tcfg.activation_dtype and conv.dtype == ssm.dtype == torch.float32
    assert conv.shape == (2, 3, tcfg.d_inner + 2 * tcfg.ssm_state)
    assert ssm.shape == (2, tcfg.ssm_heads, tcfg.ssm_state, tcfg.ssm_head_dim)
    _close(y, jy, tol)
    _close(conv, jconv, CACHE_TOL)
    _close(ssm, jssm, tol)

    step = x[:, :1] * 0.5
    y1, (c1, s1) = m0.decode(torch.from_numpy(step).to(tcfg.activation_dtype), conv, ssm)
    jy1, (jc1, js1) = jax.jit(lambda *a: JS.mamba2_decode(*a, jcfg))(
        p0, jnp.asarray(step, jcfg.activation_dtype), jnp.asarray(conv.detach().numpy()),
        jnp.asarray(ssm.detach().numpy()))
    _close(y1, jy1, tol)
    _close(c1, jc1, CACHE_TOL)
    _close(s1, js1, CACHE_TOL)


# ------------------------------------------------------ prefill, decode


def test_prefill_and_decode_steps_against_jax():
    """A prompt of 45 (past the window of 32: a ring; 3 SSD chunks, padded), 4 steps."""
    jcfg, params, tcfg, model = _models()
    B, S, steps = 2, 45, 4
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    jprefill, jdecode = _jax_fns(jcfg, S + steps)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(tokens)})
    logits, cache = TM.prefill(model, torch.from_numpy(tokens), max_len=S + steps)
    assert logits.shape == (B, 1, tcfg.vocab)
    assert cache["kv"]["k"].shape == (tcfg.num_attn_invocations, B, tcfg.attn_window,
                                      tcfg.num_kv_heads, tcfg.head_dim)
    _close(logits, jlogits, LOGIT_TOL)
    _close_caches(cache, jcache)

    tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    for _ in range(steps):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        conv, pos = cache["conv"].clone(), cache["pos"].clone()
        logits, new = TM.decode_step(model, cache, torch.from_numpy(tok))
        _close(logits, jlogits, LOGIT_TOL)
        _close_caches(new, jcache)
        assert new["kv"]["k"] is cache["kv"]["k"]  # the shared block's K/V in place
        assert torch.equal(cache["conv"], conv) and torch.equal(cache["pos"], pos)
        cache = new
        tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    back = lm_cache_from_jax(jcache)  # the JAX cache crosses leaf by leaf
    assert set(back) == {"pos", "conv", "ssm", "kv"}
    assert [t.shape for t in tree_leaves(back)] == [t.shape for t in tree_leaves(cache)]


def _both_runs(dtype, tokens, steps, feed=None):
    """Prefill and ``steps`` decode steps of both packages: a step's (JAX, port) leaves.

    The steps take ``feed``'s tokens, else JAX's greedy ones; returns the
    leaves (logits first, then the cache's) and the tokens fed.
    """
    jcfg, params, _, model = _models(dtype)
    S = tokens.shape[1]
    jprefill, jdecode = _jax_fns(jcfg, S + steps)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(tokens)})
    logits, cache = TM.prefill(model, torch.from_numpy(tokens), max_len=S + steps)
    f32 = lambda tree: [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]
    out, fed = [], []
    for i in range(steps + 1):
        out.append((f32([jlogits, jcache]), f32([logits.float(), lm_cache_to_jax(cache)])))
        if i < steps:
            tok = feed[i] if feed else np.argmax(np.asarray(jlogits), -1).astype(np.int32)
            fed.append(tok)
            jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
            logits, cache = TM.decode_step(model, cache, torch.from_numpy(tok))
    return out, fed


def test_bfloat16_prefill_and_decode_steps_against_jax():
    """The smoke model in bfloat16: a prefill of 45, then 4 steps fed the float32 run's tokens.

    Either package's bf16 matmul may round an element one ulp apart from
    the other's (their float32 sums run in other orders); through 4 mamba2
    layers and 2 shared-block invocations those ulps compound to 1-3 ulps
    of values near 3 (up to 0.05 in K, 0.04 in the logits).  So at every
    step the logits and every cache leaf must lie as close to the float32
    model's as the reference's bf16 ones do (a cast in the wrong place adds
    an error of its own): within 2x of the reference's error, plus 1e-3;
    and port and reference logits within 2e-2 of the logits' scale.
    """
    tokens = np.random.default_rng(3).integers(0, 512, (2, 45)).astype(np.int32)
    truth, fed = _both_runs("float32", tokens, 4)
    half, _ = _both_runs("bfloat16", tokens, 4, feed=fed)
    for (t_jax, _), (h_jax, h_port) in zip(truth, half):
        scale = np.abs(t_jax[0]).max()
        assert np.abs(h_port[0] - h_jax[0]).max() <= BF16_TOL * scale
        for t, j, p in zip(t_jax, h_jax, h_port):
            assert p.shape == j.shape
            assert np.abs(p - t).max() <= 2 * np.abs(j - t).max() + 1e-3


@pytest.mark.parametrize("S", [20, 40])  # inside the window; past it (the ring)
def test_prefill_then_decode_equals_a_longer_prefill(S):
    _, _, tcfg, model = _models()
    toks = torch.from_numpy(np.random.default_rng(S).integers(0, tcfg.vocab, (2, S + 1)))
    _, cache = TM.prefill(model, toks[:, :S], max_len=S + 4)
    dec, _ = TM.decode_step(model, cache, toks[:, S:])
    full, _ = TM.prefill(model, toks, max_len=S + 4)
    torch.testing.assert_close(dec, full, rtol=LOGIT_TOL, atol=LOGIT_TOL)


# ----------------------------------------------------- engine, launcher


def test_engine_matches_the_jax_engine_and_sequential():
    """Prompts of 20, 9 and 37 (a padded chunk; past the window) into 2 slots."""
    jcfg, params, tcfg, model = _models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, (n,)).astype(np.int32) for n in (20, 9, 37)]
    n_new, capacity = 6, 40
    jeng = JaxEngine(jcfg, params, max_slots=2, prompt_capacity=capacity,
                     max_new_tokens=n_new)
    teng = ServingEngine(model, max_slots=2, prompt_capacity=capacity, max_new_tokens=n_new,
                         device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=n_new))
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=n_new))
    want = {r.uid: r.output for r in jeng.run_until_drained()}
    got = {r.uid: r.output for r in teng.run_until_drained()}
    assert got == want and all(len(v) == n_new for v in got.values())
    assert teng.cache["kv"]["k"].shape[:3] == (tcfg.num_attn_invocations, 2, tcfg.attn_window)
    for i, p in enumerate(prompts):
        one = torch.as_tensor(p[None], dtype=torch.long)
        assert serve.generate(model, one, n_new).tokens[0].tolist() == got[i]


def test_launcher_main_and_greedy_tokens(capsys):
    run = serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "19",
                      "--gen", "5", "--device", "cpu"])
    assert run.tokens.shape == (2, 5) and bool(torch.isfinite(run.logits).all())
    assert "prefill: 2x19" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", ARCH, "--smoke"])

    jcfg, params, tcfg, model = _models()
    prompts = serve.make_inputs(tcfg, 2, 19, 0, "cpu")["tokens"]
    run = serve.generate(model, prompts, 5)
    jprefill, jdecode = _jax_fns(jcfg, 24)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(prompts.numpy(), jnp.int32)})
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for _ in range(4):
        jlogits, jcache = jdecode(params, jcache, tok)
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(run.tokens.numpy(), np.concatenate(want, 1))
