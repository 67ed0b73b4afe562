"""Falcon-Mamba serving: the port against the JAX package, on the CPU.

On the ``falcon-mamba-7b`` smoke config, with the weights of
``repro.models.model.init_model(jax.random.key(0), cfg)`` converted across:

* configs, the registry and init: the same field values, parameter names,
  shapes and dtypes as the reference;
* ``rmsnorm`` and both forms of the causal conv;
* ``mamba1_forward`` (against the JAX chunked scan and the Pallas kernel in
  interpret mode) and ``mamba1_decode``: float32 at 1e-5, and a bfloat16
  model at 2e-2, which catches a cast in the wrong place;
* ``prefill`` (logits at 1e-4, caches at 1e-5, ``pos``) and one
  ``decode_step``;
* the serving engine on tests/test_serving.py's three ragged prompts, token
  for token against the JAX engine; the launcher's ``main`` on the CPU;
* a bfloat16 round trip through the converter.
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
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, KNOWN_ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_jax,
    lm_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "falcon-mamba-7b"
F32_TOL = 1e-5
BF16_TOL = 2e-2
LOGIT_TOL = 1e-4


@functools.cache
def _models(dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port model) on the smoke config."""
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    params = jax.jit(JM.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    return jcfg, params, tcfg, lm_params_from_jax(params, tcfg)


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def _layer0(params):
    return jax.tree_util.tree_map(lambda x: x[0], params["layers"])


# ------------------------------------------------------------ config, init


def test_configs_registry_and_init_match_the_reference():
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.param_count() == ref.param_count()
        assert port.d_inner == ref.d_inner
    assert get_config(ARCH).activation_dtype == torch.bfloat16
    assert get_config(ARCH).param_count() == 7_271_612_416
    for arch in KNOWN_ARCH_IDS:
        if arch not in ARCH_IDS:
            with pytest.raises(NotImplementedError, match=arch):
                get_config(arch)
    with pytest.raises(KeyError):
        get_smoke_config("no-such-arch")

    # the port's own init: JAX's names, shapes and dtypes, float32 and bfloat16
    for dtype in ("float32", "bfloat16"):
        jcfg, params, tcfg, _ = _models(dtype)
        model = TM.init_model(torch.Generator().manual_seed(0), tcfg)
        got = jax.tree_util.tree_map(
            lambda x: (x.shape, str(x.dtype)), lm_params_to_jax(model)
        )
        want = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), params)
        assert got == want
        m = model.layers[0].mamba
        assert torch.equal(m.D, torch.ones_like(m.D)) and not m.conv_b.any()
        assert torch.allclose(torch.exp(m.A_log[3]), torch.arange(1.0, 17.0))
        dt = torch.nn.functional.softplus(m.dt_proj_b)
        assert bool(((dt > 0.99e-3) & (dt < 1.01e-1)).all())


def test_bfloat16_leaves_cross_the_converter():
    _, params, tcfg, model = _models("bfloat16")
    leaf = params["embed"]["embedding"]
    t = params_from_jax({"e": leaf})["e"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(leaf, np.float32))
    back = lm_params_to_jax(model)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    assert model.layers[1].mamba.in_proj.dtype == torch.bfloat16
    # per layer: the norm's scale and nine Mamba1 leaves; embed, unembed, final norm
    assert len(tree_leaves(model.tree())) == tcfg.num_layers * 10 + 3


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_both_conv_forms(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    scale = rng.normal(size=(24,)).astype(np.float32)
    w = rng.normal(size=(24, 4)).astype(np.float32)
    state = rng.normal(size=(2, 3, 24)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                         torch.float32)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    out = TL.rmsnorm(torch.from_numpy(scale), tx)
    assert out.dtype == td
    _close(out, JL.rmsnorm({"scale": jnp.asarray(scale)}, jx), tol)
    _close(TL.causal_depthwise_conv1d(tx, torch.from_numpy(w).to(td)),
           JL.causal_depthwise_conv1d(jx, jnp.asarray(w, jd)), tol)
    y, new = TL.causal_depthwise_conv1d(
        torch.from_numpy(x[:, :1]), torch.from_numpy(w), state=torch.from_numpy(state))
    jy, jnew = JL.causal_depthwise_conv1d(
        jnp.asarray(x[:, :1]), jnp.asarray(w), state=jnp.asarray(state))
    _close(y, jy, F32_TOL)
    _close(new, jnew, 0.0)


# ------------------------------------------------------------------ mamba1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_forward_and_decode(dtype):
    jcfg, params, tcfg, model = _models(dtype)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 21, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.activation_dtype)
    tx = torch.from_numpy(x).to(tcfg.activation_dtype)
    p0, m0 = _layer0(params), model.layers[0].mamba

    y, (conv, ssm) = TS.mamba1_forward(m0, tx, tcfg)
    assert y.dtype == tcfg.activation_dtype and conv.dtype == ssm.dtype == torch.float32
    for use_pallas in (False, True):  # the jnp chunked scan; the Pallas kernel
        cfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
        jy, (jconv, jssm) = jax.jit(
            lambda p, x, cfg=cfg: JS.mamba1_forward(p, x, cfg))(p0["mamba"], jx)
        _close(y, jy, tol)
        _close(conv, jconv, F32_TOL)
        _close(ssm, jssm, tol)

    jconv, jssm = jnp.asarray(conv.detach().numpy()), jnp.asarray(ssm.detach().numpy())
    step = x[:, :1] * 0.5
    y1, (c1, s1) = m0.decode(torch.from_numpy(step).to(tcfg.activation_dtype), conv, ssm)
    jy1, (jc1, js1) = jax.jit(lambda *a: JS.mamba1_decode(*a, jcfg))(
        p0["mamba"], jnp.asarray(step, jcfg.activation_dtype), jconv, jssm)
    _close(y1, jy1, tol)
    _close(c1, jc1, F32_TOL)
    _close(s1, js1, F32_TOL)


# ------------------------------------------------------- prefill and decode


def test_prefill_and_decode_step():
    jcfg, params, tcfg, model = _models()
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab, (3, 19))
    jlogits, jcache = jax.jit(lambda p, b: JM.prefill(p, b, jcfg))(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    logits, cache = TM.prefill(model, torch.from_numpy(tokens))
    assert logits.shape == (3, 1, tcfg.vocab)
    _close(logits, jlogits, LOGIT_TOL)
    for name in ("conv", "ssm"):
        assert cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name], F32_TOL)
    assert cache["pos"].dtype == torch.int32
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    # a cache crosses the converter as it is: both packages stack along L
    back = params_from_jax(params_to_jax(cache))
    assert all(torch.equal(back[k], cache[k]) for k in cache)

    nxt = np.argmax(np.asarray(jlogits), -1)
    jl2, jc2 = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg))(
        params, jcache, jnp.asarray(nxt, jnp.int32))
    l2, c2 = TM.decode_step(model, cache, torch.from_numpy(nxt))
    _close(l2, jl2, LOGIT_TOL)
    for name in ("conv", "ssm"):
        _close(c2[name], jc2[name], F32_TOL)
    np.testing.assert_array_equal(c2["pos"].numpy(), np.asarray(jc2["pos"]))
    assert torch.equal(cache["pos"], torch.full((3,), 19, dtype=torch.int32))  # input kept

    with pytest.raises(NotImplementedError, match="mamba2"):
        TM.init_cache(dataclasses.replace(tcfg, mamba_version=2), 1, 8, "cpu")


# ----------------------------------------------------- engine and launcher


def test_engine_matches_the_jax_engine():
    jcfg, params, tcfg, model = _models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, (n,)).astype(np.int32) for n in (12, 9, 15)]
    n_new = 6

    jeng = JaxEngine(jcfg, params, max_slots=2, prompt_capacity=16, max_new_tokens=n_new)
    teng = ServingEngine(model, max_slots=2, device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=n_new))
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=n_new))
    want = {r.uid: r.output for r in jeng.run_until_drained()}
    got = {r.uid: r.output for r in teng.run_until_drained()}
    assert got == want and all(len(v) == n_new for v in got.values())

    with pytest.raises(ValueError):
        teng.submit(Request(uid=9, prompt=np.zeros((1, 4), np.int32)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(model)


def test_launcher_main_on_the_cpu(capsys):
    run = serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "11",
                      "--gen", "5", "--device", "cpu"])
    assert run.tokens.shape == (2, 5)
    assert bool(((run.tokens >= 0) & (run.tokens < get_smoke_config(ARCH).vocab)).all())
    assert bool(torch.isfinite(run.logits.float()).all())
    out = capsys.readouterr().out
    assert "prefill: 2x11" in out and "tok/s" in out and "sample stream 0:" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", ARCH, "--smoke"])


def test_launcher_greedy_tokens_match_the_jax_model():
    """The launcher's generate on converted weights = JAX prefill + greedy decode."""
    jcfg, params, tcfg, model = _models()
    prompts = serve.make_inputs(tcfg, 2, 10, 3, "cpu")["tokens"]
    run = serve.generate(model, prompts, 4)
    jlogits, jcache = JM.prefill(params, {"tokens": jnp.asarray(prompts.numpy(), jnp.int32)},
                                 jcfg)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for _ in range(3):
        jlogits, jcache = JM.decode_step(params, jcache, tok, jcfg)
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(run.tokens.numpy(), np.concatenate(want, 1))
