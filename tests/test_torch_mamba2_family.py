"""The pure-SSM mamba2 family (``arch_type="ssm"``, ``mamba_version=2``) against JAX.

No config of the repo uses the family; the reference builds it
(``repro/models/model.py:49-50``).  Here it is the ``falcon-mamba-7b``
smoke config switched to mamba2 with heads of 32 (8 heads of the d_inner
256, chunks of 16 steps), in float32, with the weights of
``repro.models.model.init_model(jax.random.key(0), cfg)`` converted across:

* the family in `PORTED`, its parameters (names, shapes, dtypes) and
  counts, and its cache (``conv`` and ``ssm``, no ``kv``);
* ``prefill`` over a prompt of 40 (two chunks and a ragged third), then 4
  ``decode_step`` calls: logits at 1e-4 and every cache leaf at 1e-5;
* prefill and one decode step equal the training forward over the longer
  sequence (tests/test_prefill_decode.py's oracle, 2e-4 / 2e-3);
* ``forward_train``'s loss, metrics and every gradient against
  ``jax.value_and_grad``, with remat and without, and one
  ``make_train_step`` (params and Adam state), at 1e-5;
* the engine on ragged prompts: token for token the JAX engine and
  sequential generation.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_cache_to_jax,
    lm_opt_state_from_jax,
    lm_opt_state_to_jax,
    lm_params_to_jax,
    params_from_jax,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from test_torch_lm_training import (  # noqa: E402
    LR,
    check_forward_train,
    close,
    close_trees,
    jax_models,
    make_batch,
    port_model,
)

ARCH = "falcon-mamba-7b"
MAMBA2 = (("mamba_version", 2), ("ssm_head_dim", 32))
CACHE_TOL = 1e-5
LOGIT_TOL = 1e-4


@functools.cache
def _models():
    """(JAX cfg, JAX params, port model) of the family."""
    jcfg, params = jax_models(ARCH, **dict(MAMBA2))
    return jcfg, params, port_model(ARCH, params, **dict(MAMBA2))


def _close_caches(cache, jcache):
    got = lm_cache_to_jax(cache)
    assert sorted(got) == sorted(jcache) == ["conv", "pos", "ssm"]
    np.testing.assert_array_equal(got["pos"], np.asarray(jcache["pos"]))
    for name in ("conv", "ssm"):
        assert got[name].shape == jcache[name].shape
        close(got[name], jcache[name], CACHE_TOL)


def test_the_family_is_ported_with_the_reference_layout():
    jcfg, params, model = _models()
    cfg = model.cfg
    assert TM.family(cfg) == "mamba2" and TM.core_kind(cfg) == "mamba2"
    assert TM.PORTED["mamba2"] == ("training", "serving")
    assert cfg.param_count() == jcfg.param_count()
    got = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), lm_params_to_jax(
        TM.init_model(torch.Generator().manual_seed(0), cfg)))
    assert got == jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), params)
    assert model.shared_attn is None and all(p.requires_grad for p in model.parameters())
    cache = TM.init_cache(cfg, 3, 8, "cpu")
    assert cache["conv"].shape == (2, 3, 3, cfg.d_inner + 2 * cfg.ssm_state)
    assert cache["ssm"].shape == (2, 3, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    jcache = JM.init_cache(jcfg, 3, 8)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}


def test_prefill_and_decode_steps_against_jax():
    jcfg, params, model = _models()
    B, S, steps = 2, 40, 4
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, b: JM.prefill(p, b, jcfg, max_len=S + steps))(
        params, {"tokens": jnp.asarray(tokens)})
    logits, cache = TM.prefill(model, torch.from_numpy(tokens), max_len=S + steps)
    assert logits.shape == (B, 1, jcfg.vocab)
    close(logits, jlogits, LOGIT_TOL)
    _close_caches(cache, jcache)
    jdecode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg))
    tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    for _ in range(steps):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        before = {k: v.clone() for k, v in cache.items()}
        logits, new = TM.decode_step(model, cache, torch.from_numpy(tok))
        close(logits, jlogits, LOGIT_TOL)
        _close_caches(new, jcache)
        assert all(torch.equal(cache[k], before[k]) for k in cache)  # the input is kept
        cache = new
        tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)


def test_prefill_then_decode_matches_the_training_forward():
    _, _, model = _models()
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 33)))
    last, cache = TM.prefill(model, toks[:, :32])
    with torch.no_grad():
        h, _ = TM._run_layers_train(model, TM._embed_tokens(model, toks))
        full = TM._logits(model, h)
    torch.testing.assert_close(last[:, -1], full[:, 31], rtol=2e-4, atol=2e-4)
    dec, _ = TM.decode_step(model, cache, toks[:, 32:])
    torch.testing.assert_close(dec[:, 0], full[:, 32], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("remat", [True, False])
def test_forward_train_matches(remat):
    check_forward_train(ARCH, MAMBA2, MAMBA2 + (("remat", remat),))


def test_one_train_step_matches():
    """One step from a state one JAX step left: params, both Adam moments, metrics."""
    jcfg, params = jax_models(ARCH, **dict(MAMBA2))
    opt_j, step_j = jax_make_train_step(jcfg, LR)
    step_j = jax.jit(step_j)
    params, state, _ = step_j(params, opt_j.init(params), make_batch(jcfg, 4, seed=4))
    batch = make_batch(jcfg, 4, seed=5)
    want_p, want_s, want_m = step_j(params, state, batch)

    model = port_model(ARCH, params, **dict(MAMBA2))
    _, step = make_train_step(model.cfg, LR)
    model, t_state, metrics = step(model, lm_opt_state_from_jax(state, model.cfg),
                                   params_from_jax(batch))
    assert sorted(metrics) == sorted(want_m)
    for name in metrics:
        close(metrics[name], want_m[name])
    close_trees(lm_params_to_jax(model), want_p)
    close_trees(lm_opt_state_to_jax(t_state), want_s)


def test_engine_matches_the_jax_engine_and_sequential():
    """Prompts of 20, 9 and 37 (a ragged chunk) into 2 slots."""
    jcfg, params, model = _models()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, (n,)).astype(np.int32) for n in (20, 9, 37)]
    n_new, capacity = 5, 40
    jeng = JaxEngine(jcfg, params, max_slots=2, prompt_capacity=capacity, max_new_tokens=n_new)
    teng = ServingEngine(model, max_slots=2, prompt_capacity=capacity, max_new_tokens=n_new,
                         device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=n_new))
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=n_new))
    want = {r.uid: r.output for r in jeng.run_until_drained()}
    got = {r.uid: r.output for r in teng.run_until_drained()}
    assert got == want and all(len(v) == n_new for v in got.values())
    assert "kv" not in teng.cache
    for i, p in enumerate(prompts):
        one = torch.as_tensor(p[None], dtype=torch.long)
        assert serve.generate(model, one, n_new).tokens[0].tolist() == got[i]
