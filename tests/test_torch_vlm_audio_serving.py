"""LLaVA-NeXT (vlm) and MusicGen (audio) serving: the port against the JAX package, on the CPU.

On the ``llava-next-mistral-7b`` smoke config (16 vision tokens ahead of
the text, GQA 4/2) and the ``musicgen-large`` one (4 codebooks), with the
weights of ``repro.models.model.init_model(jax.random.key(0), cfg)``
converted across:

* the configs, the registry and ``param_count``, and the port's own init
  (the JAX names, shapes and dtypes: an audio model's (K, V, d) tables and
  (K, d, V) heads);
* the delay pattern against ``repro.models.audio``, and its round trip;
* ``prefill`` with ``vision_embeds`` (vlm) or (B, S, K) tokens (audio),
  then 4 ``decode_step`` calls: logits ((B, 1, K, V) for audio) at 1e-4
  and every cache leaf at 1e-5 in float32, 2e-2 in bfloat16;
* a prefill of S positions and one decode step = a prefill of S + 1;
* the launcher's prompt draws (the reference's, from one numpy generator;
  a vlm prompt no longer than its vision tokens raises), its ``main`` and
  its greedy tokens against JAX;
* the serving engine raising for both, as the reference's does.
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
from repro.models import audio as JAu  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import lm_cache_to_jax, lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import audio as TAu  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

VLM, AUDIO = "llava-next-mistral-7b", "musicgen-large"
CACHE_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 2e-2


@functools.cache
def _models(arch, dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port model) on ``arch``'s smoke config."""
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
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


def _close_caches(cache, jcache, tol):
    got = lm_cache_to_jax(cache)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jcache)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jcache)):
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype)
        _close(np.asarray(g, np.float32), w, tol)


def _inputs(tcfg, S, seed):
    """The launcher's draws, as the JAX prefill's batch and the port's arguments."""
    inputs = serve.make_inputs(tcfg, 2, S, seed, "cpu")
    batch = {"tokens": jnp.asarray(inputs["tokens"].numpy(), jnp.int32)}
    if "vision_embeds" in inputs:
        batch["vision_embeds"] = jnp.asarray(inputs["vision_embeds"].float().numpy(),
                                             jnp.float32)
    return batch, inputs


# ----------------------------------------------------------- config, init


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_configs_registry_and_counts_match_the_reference(arch):
    assert arch in ARCH_IDS
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_get_smoke_config(arch))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.param_count() == ref.param_count()
        assert port.flops_param_count() == ref.flops_param_count()
    want = {VLM: 7_241_728_000, AUDIO: 3_254_976_512}[arch]
    assert get_config(arch).param_count() == want


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_init_matches_the_reference_layout(arch):
    _, params, tcfg, model = _models(arch)
    own = TM.init_model(torch.Generator().manual_seed(0), tcfg)
    shapes = lambda tree: jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), tree)
    assert shapes(lm_params_to_jax(own)) == shapes(params)
    assert shapes(lm_params_to_jax(model)) == shapes(params)
    assert all(p.requires_grad for p in own.parameters())  # served and trained
    if arch == AUDIO:
        K, V, d = tcfg.num_codebooks, tcfg.vocab, tcfg.d_model
        assert own.embed.embedding.shape == (K, V, d) and own.unembed.w.shape == (K, d, V)
    assert len(tree_leaves(own.tree())) == tcfg.num_layers * 9 + 3


# ---------------------------------------------------------- delay pattern


@pytest.mark.parametrize("S,K", [(7, 4), (4, 4), (9, 2)])
def test_delay_pattern_against_jax(S, K):
    tokens = np.random.default_rng(S * K).integers(0, 50, (2, S, K)).astype(np.int32)
    delayed = TAu.apply_delay_pattern(torch.from_numpy(tokens), -1)
    np.testing.assert_array_equal(delayed.numpy(),
                                  np.asarray(JAu.apply_delay_pattern(jnp.asarray(tokens), -1)))
    back = TAu.revert_delay_pattern(delayed, -1)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(JAu.revert_delay_pattern(jnp.asarray(
                                      delayed.numpy()), -1)))
    for k in range(K):  # the valid region round-trips; the rest is pad
        np.testing.assert_array_equal(back[:, :S - k, k].numpy(), tokens[:, :S - k, k])
        assert bool((back[:, S - k:, k] == -1).all())


# ------------------------------------------------------ prefill, decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_prefill_and_decode_steps_against_jax(arch, dtype):
    """A prompt of 40 positions (vlm: 16 vision + 24 text), then 4 greedy steps."""
    jcfg, params, tcfg, model = _models(arch, dtype)
    logit_tol, cache_tol = (BF16_TOL, BF16_TOL) if dtype == "bfloat16" else (LOGIT_TOL,
                                                                             CACHE_TOL)
    S, steps = 40, 4
    batch, inputs = _inputs(tcfg, S, seed=3)
    jprefill, jdecode = _jax_fns(jcfg, S + steps)
    jlogits, jcache = jprefill(params, batch)
    logits, cache = TM.prefill(model, inputs["tokens"], max_len=S + steps,
                               vision_embeds=inputs.get("vision_embeds"))
    K = tcfg.num_codebooks
    assert logits.shape == ((2, 1, K, tcfg.vocab) if K else (2, 1, tcfg.vocab))
    assert cache["kv"]["k"].shape[2] == S + steps and int(cache["pos"][0]) == S
    _close(logits, jlogits, logit_tol)
    _close_caches(cache, jcache, cache_tol)

    tok = np.argmax(np.asarray(jlogits, np.float32), -1).astype(np.int32)  # (B,1[,K])
    for _ in range(steps):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        logits, cache = TM.decode_step(model, cache, torch.from_numpy(tok))
        _close(logits, jlogits, logit_tol)
        _close_caches(cache, jcache, cache_tol)
        tok = np.argmax(np.asarray(jlogits, np.float32), -1).astype(np.int32)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_prefill_then_decode_equals_a_longer_prefill(arch):
    _, _, tcfg, model = _models(arch)
    inputs = serve.make_inputs(tcfg, 2, 33, 5, "cpu")
    toks, vision = inputs["tokens"], inputs.get("vision_embeds")
    _, cache = TM.prefill(model, toks[:, :-1], max_len=36, vision_embeds=vision)
    dec, _ = TM.decode_step(model, cache, toks[:, -1:])
    full, _ = TM.prefill(model, toks, max_len=36, vision_embeds=vision)
    torch.testing.assert_close(dec, full, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_vision_embeds_go_with_a_vlm_prompt_only():
    _, _, vcfg, vlm = _models(VLM)
    _, _, acfg, audio = _models(AUDIO)
    with pytest.raises(ValueError, match="vision_embeds"):
        TM.prefill(vlm, torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="vision_embeds"):
        TM.prefill(audio, torch.zeros(1, 4, 4, dtype=torch.long),
                   vision_embeds=torch.zeros(1, 2, acfg.d_model))


# ----------------------------------------------------- launcher, engine


def test_launcher_draws_the_references_prompts():
    """serve.py:37-47: audio tokens (B, S, K); vlm text tokens (B, S - V), then
    the vision embeddings, from one generator."""
    for arch in (VLM, AUDIO):
        cfg = get_smoke_config(arch)
        inputs = serve.make_inputs(cfg, 3, 20, 7, "cpu")
        rng = np.random.default_rng(7)
        if arch == AUDIO:
            want = rng.integers(0, cfg.vocab, (3, 20, cfg.num_codebooks))
        else:
            want = rng.integers(0, cfg.vocab, (3, 20 - cfg.vision_tokens))
            vision = rng.normal(size=(3, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
            np.testing.assert_array_equal(inputs["vision_embeds"].numpy(), vision)
        np.testing.assert_array_equal(inputs["tokens"].numpy(), want)
    with pytest.raises(ValueError, match="vision tokens"):
        serve.make_inputs(get_smoke_config(VLM), 1, 16, 0, "cpu")


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_launcher_main_and_greedy_tokens(arch, capsys):
    run = serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "21",
                      "--gen", "4", "--device", "cpu"])
    jcfg, params, tcfg, model = _models(arch)
    K = tcfg.num_codebooks
    assert run.tokens.shape == ((2, 4, K) if K else (2, 4))
    assert bool(torch.isfinite(run.logits).all())
    assert "prefill: 2x21" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", arch, "--smoke"])

    batch, inputs = _inputs(tcfg, 21, seed=0)
    run = serve.generate(model, inputs["tokens"], 4, inputs.get("vision_embeds"))
    jprefill, jdecode = _jax_fns(jcfg, 25)
    jlogits, jcache = jprefill(params, batch)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for _ in range(3):
        jlogits, jcache = jdecode(params, jcache, tok)
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(run.tokens.numpy(), np.concatenate(want, 1))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_engine_raises_as_the_reference_does(arch):
    _, _, _, model = _models(arch)
    with pytest.raises(NotImplementedError, match="token-only"):
        ServingEngine(model, device="cpu")
