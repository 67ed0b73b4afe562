"""Dense LM training: the port against the JAX package, on the CPU.

On the ``internlm2-1.8b`` smoke config, with the weights of
``repro.models.model.init_model(jax.random.key(0), cfg)`` converted across:

* configs, the registry, parameter counts and init: the same field values,
  parameter names, shapes and dtypes as the reference;
* ``apply_rope``, the SwiGLU ``mlp``, ``chunked_causal_attention`` (both
  sweeps) and ``attention_full`` against both JAX branches (``use_pallas``
  False: the chunked jnp attention; True: the Pallas kernel in interpret
  mode);
* ``forward_train``'s loss and every gradient at 1e-5, with and without
  remat;
* one ``make_train_step`` (params and optimizer state) at 1e-5 from a state
  that one JAX step left, and a ``grad_accum=2`` step.

tests/test_torch_dense_launch.py holds the data, converter and launcher
tests of the same slice.
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
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _stack_layers,
    lm_opt_state_from_jax,
    lm_opt_state_to_jax,
    lm_params_from_jax,
    lm_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCH = "internlm2-1.8b"
TOL = 1e-5
LR = 3e-4


@functools.cache
def _models(dtype="float32"):
    """(JAX cfg, JAX params, port cfg) on the smoke config."""
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    params = jax.jit(JM.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    return jcfg, params, tcfg


def _model(dtype="float32", **changes):
    """(JAX params, the port's `LM` of them) with ``changes`` to the port's cfg."""
    jcfg, params, tcfg = _models(dtype)
    return params, lm_params_from_jax(params, dataclasses.replace(tcfg, **changes))


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_trees(got, want, tol=TOL):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert np.shape(x) == np.shape(y)
        _close(x, y, tol)


def _layer0(params):
    return jax.tree_util.tree_map(lambda x: x[0], params["layers"])


# ------------------------------------------------------------ config, init


def test_configs_counts_and_init_match_the_reference():
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.flops_param_count() == ref.flops_param_count()
        assert TM.model_flops_per_token(port) == JM.model_flops_per_token(ref)
    assert get_config(ARCH).param_count() == 1_889_107_968
    assert get_config(ARCH).head_dim == 128
    _, params, tcfg = _models()
    model = TM.init_model(torch.Generator().manual_seed(0), tcfg)
    got = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), lm_params_to_jax(model))
    assert got == jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), params)
    assert all(p.requires_grad for p in model.parameters())


# ------------------------------------------------------------------ layers


def test_rope_and_mlp_match_the_reference():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 12, 4, 32)), jnp.float32)
    pos = jnp.arange(12)
    rope = jax.jit(JL.apply_rope, static_argnums=2)
    _close(TL.apply_rope(params_from_jax(x), torch.arange(12), 10000.0),
           rope(x, pos, 10000.0))
    xb = x.astype(jnp.bfloat16)
    _close(TL.apply_rope(params_from_jax(xb), torch.arange(12), 1e6), rope(xb, pos, 1e6), 1e-2)

    params, model = _model()
    h = jnp.asarray(rng.normal(size=(2, 12, 128)), jnp.float32)
    _close(TL.mlp(model.layers[0].mlp, params_from_jax(h)),
           jax.jit(JL.mlp)(_layer0(params)["mlp"], h))


@pytest.mark.parametrize("S,window,skip", [(24, 0, False), (21, 0, True), (21, 5, False)])
def test_chunked_causal_attention_matches_the_reference(S, window, skip):
    rng = np.random.default_rng(2)
    q = jnp.asarray(rng.normal(size=(2, S, 4, 32)), jnp.float32)
    k, v = (jnp.asarray(rng.normal(size=(2, S, 2, 32)), jnp.float32) for _ in range(2))
    want = jax.jit(lambda q, k, v: JA.chunked_causal_attention(
        q, JA._expand_kv(k, 2), JA._expand_kv(v, 2), window, 8, skip))(q, k, v)
    tq, tk, tv = params_from_jax([q, k, v])
    got = TA.chunked_causal_attention(tq, TA._expand_kv(tk, 2), TA._expand_kv(tv, 2), window, 8,
                                      causal_skip=skip)
    _close(got, want)
    # and the flash op computes the same attention without expanding k and v
    flash = flash_attention(*(t.transpose(1, 2).contiguous() for t in (tq, tk, tv)),
                            window=window)
    _close(flash.transpose(1, 2), want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_full_matches_both_reference_branches(use_pallas):
    jcfg, params, _ = _models()
    _, model = _model()
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    x = jnp.asarray(np.random.default_rng(3).normal(size=(2, 24, 128)), jnp.float32)
    want = jax.jit(JA.attention_full, static_argnums=3)(
        _layer0(params)["attn"], x, jnp.arange(24), jcfg)
    got = TA.attention_full(model.layers[0].attn, params_from_jax(x), torch.arange(24),
                            model.cfg)
    _close(got, want)


# ---------------------------------------------------------------- training


def _port_grads(model, batch):
    loss, metrics = TM.forward_train(model, params_from_jax(batch))
    loss.backward()
    grads = params_to_jax(_stack_layers(model.tree(lambda p: p.grad)))
    return loss, metrics, grads


@pytest.mark.parametrize("remat", [True, False])
def test_forward_train_loss_and_grads_match(remat):
    jcfg, params, _ = _models()
    _, model = _model(remat=remat)
    batch = _batch(jcfg)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, b, jcfg), has_aux=True))(params, batch)
    loss, metrics, grads = _port_grads(model, batch)
    _close(loss, loss_j)
    assert sorted(metrics) == sorted(metrics_j)
    _close(metrics["lm_loss"], metrics_j["lm_loss"])
    _close_trees(grads, grads_j)


@functools.cache
def _jax_step(jcfg):
    _, step = jax_make_train_step(jcfg, LR)
    return jax.jit(step)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_one_train_step_matches(grad_accum):
    jcfg, params, tcfg = _models()
    jcfg = dataclasses.replace(jcfg, grad_accum=grad_accum)
    tcfg = dataclasses.replace(tcfg, grad_accum=grad_accum)
    opt_j, _ = jax_make_train_step(jcfg, LR)
    # one JAX step first, so both packages start from a state with moments
    params, state, _ = _jax_step(jcfg)(params, opt_j.init(params), _batch(jcfg, B=4, seed=4))
    batch = _batch(jcfg, B=4, seed=5)
    want_p, want_s, want_m = _jax_step(jcfg)(params, state, batch)

    model = lm_params_from_jax(params, tcfg)
    opt, step = make_train_step(tcfg, LR)
    t_state = lm_opt_state_from_jax(state, tcfg)
    assert int(t_state[1].count) == 1
    model, t_state, metrics = step(model, t_state, params_from_jax(batch))
    _close(metrics["loss"], want_m["loss"])
    _close_trees(lm_params_to_jax(model), want_p)
    _close_trees(lm_opt_state_to_jax(t_state), want_s)
    assert int(t_state[1].count) == 2
    # and the port's own init of the state is JAX's
    _close_trees(lm_opt_state_to_jax(opt.init(model.tree())), opt_j.init(want_p))


def test_other_families_do_not_train_yet():
    """Every family trains (tests/test_torch_lm_training*.py and
    tests/test_torch_mamba2_family.py hold them against JAX), the pure-SSM
    mamba2 model too, which no config uses and the port once refused: its
    loss on the reference's weights is JAX's, and its cache is the
    reference's conv and SSM states."""
    _, model = _model()
    for arch in ("olmoe-1b-7b", "falcon-mamba-7b"):
        other = TM.init_model(torch.Generator().manual_seed(0), get_smoke_config(arch))
        loss, metrics = TM.forward_train(other, params_from_jax(_batch(model.cfg)))
        assert bool(torch.isfinite(loss)) and metrics["loss"] is loss
    jcfg = dataclasses.replace(jax_get_smoke_config("falcon-mamba-7b"), mamba_version=2)
    tcfg = dataclasses.replace(get_smoke_config("falcon-mamba-7b"), mamba_version=2)
    params = jax.jit(JM.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    batch = _batch(tcfg)
    want, _ = jax.jit(lambda p, b: JM.forward_train(p, b, jcfg))(params, batch)
    loss, _ = TM.forward_train(lm_params_from_jax(params, tcfg), params_from_jax(batch))
    _close(loss, want)
    TM._require_ported(tcfg, "training")
    cache = TM.init_cache(tcfg, 1, 4, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in JM.init_cache(jcfg, 1, 4).items()}
