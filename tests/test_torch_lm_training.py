"""LM training of the moe, vlm and audio families: the port against the JAX package.

On each family's smoke config in float32 (``olmoe-1b-7b``: 4 experts, top
2, groups of 64; ``llava-next-mistral-7b``: 16 vision embeddings ahead of
the text; ``musicgen-large``: 4 codebook tables and heads), with the weights
of ``repro.models.model.init_model(jax.random.key(0), cfg)`` converted
across:

* ``forward_train``'s loss, every metric (the reference's keys: ``lm_loss``
  and ``loss``, an MoE model's ``router_aux`` and ``router_z`` as well) and
  every gradient leaf against ``jax.value_and_grad(JM.forward_train)`` at
  1e-5, MoE with remat and without;
* one ``make_train_step`` (params and both Adam moments after it) at 1e-5
  from a state that one JAX step left; MoE also at ``grad_accum=2``;
* the pure-SSM ``mamba_version=2`` model, which no config uses, trained
  as the reference trains it (tests/test_torch_mamba2_family.py holds its
  serving and its train step).

tests/test_torch_lm_training_ssm.py holds the mamba1 and hybrid families
(and the selective scan's backward), tests/test_torch_lm_training_launch.py
the launcher's batches and checkpoints; both import this file's helpers.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _stack_layers,
    lm_opt_state_from_jax,
    lm_opt_state_to_jax,
    lm_params_from_jax,
    lm_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MOE, VLM, AUDIO = "olmoe-1b-7b", "llava-next-mistral-7b", "musicgen-large"
TOL = 1e-5
LR = 3e-4


@functools.cache
def jax_models(arch, **changes):
    """(JAX cfg, JAX params) on ``arch``'s smoke config in float32, with ``changes``."""
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype="float32", **changes)
    return jcfg, jax.jit(JM.init_model, static_argnums=1)(jax.random.key(0), jcfg)


def port_model(arch, params, **changes):
    """A fresh port `LM` of JAX ``params`` on ``arch``'s smoke config, with ``changes``."""
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **changes)
    return lm_params_from_jax(params, tcfg)


def make_batch(cfg, B=2, S=24, seed=0):
    """A numpy training batch: (B, S) tokens, (B, S, K) for audio, vlm's embeddings."""
    rng = np.random.default_rng(seed)
    K = cfg.num_codebooks
    toks = rng.integers(0, cfg.vocab, (B, S + 1, K) if K else (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = rng.normal(size=(B, cfg.vision_tokens, cfg.d_model)).astype(
            np.float32)
    return batch


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def close_trees(got, want, tol=TOL):
    """Equal key paths (the namedtuples may be either package's), leaves within ``tol``."""
    got, want = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (got, want))
    assert [jax.tree_util.keystr(k) for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (_, x), (_, y) in zip(got, want):
        assert np.shape(x) == np.shape(y)
        close(x, y, tol)


@functools.cache
def _jax_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: JM.forward_train(p, b, jcfg), has_aux=True))


def check_forward_train(arch, jax_changes=(), port_changes=(), B=2, S=24):
    """forward_train's loss, metrics and every gradient, port against JAX."""
    jcfg, params = jax_models(arch, **dict(jax_changes))
    model = port_model(arch, params, **dict(port_changes))
    batch = make_batch(jcfg, B, S)
    (loss_j, metrics_j), grads_j = _jax_value_and_grad(jcfg)(params, batch)
    loss, metrics = TM.forward_train(model, params_from_jax(batch))
    loss.backward()
    grads = params_to_jax(_stack_layers(model.tree(lambda p: p.grad)))
    close(loss, loss_j)
    assert sorted(metrics) == sorted(metrics_j)
    for name in metrics:
        close(metrics[name], metrics_j[name])
    close_trees(grads, grads_j)
    return metrics


@functools.cache
def _jax_step(jcfg):
    _, step = jax_make_train_step(jcfg, LR)
    return jax.jit(step)


def check_train_step(arch, grad_accum=1):
    """One make_train_step from a state one JAX step left: params, Adam state, metrics."""
    jcfg, params = jax_models(arch, grad_accum=grad_accum)
    opt_j, _ = jax_make_train_step(jcfg, LR)
    params, state, _ = _jax_step(jcfg)(params, opt_j.init(params), make_batch(jcfg, 4, seed=4))
    batch = make_batch(jcfg, 4, seed=5)
    want_p, want_s, want_m = _jax_step(jcfg)(params, state, batch)

    model = port_model(arch, params, grad_accum=grad_accum)
    _, step = make_train_step(model.cfg, LR)
    t_state = lm_opt_state_from_jax(state, model.cfg)
    model, t_state, metrics = step(model, t_state, params_from_jax(batch))
    assert sorted(metrics) == sorted(want_m)
    for name in metrics:
        close(metrics[name], want_m[name])
    close_trees(lm_params_to_jax(model), want_p)
    close_trees(lm_opt_state_to_jax(t_state), want_s)
    assert int(t_state[1].count) == 2


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("arch,remat", [(MOE, True), (MOE, False), (VLM, True), (AUDIO, True)])
def test_forward_train_loss_metrics_and_grads_match(arch, remat):
    metrics = check_forward_train(arch, port_changes={"remat": remat}.items())
    if arch == MOE:
        assert all(float(metrics[k].detach()) > 0 for k in ("router_aux", "router_z"))


@pytest.mark.parametrize("arch,grad_accum", [(MOE, 1), (MOE, 2), (VLM, 1), (AUDIO, 1)])
def test_one_train_step_matches(arch, grad_accum):
    check_train_step(arch, grad_accum)


def test_every_parameter_trains_and_pure_mamba2_stays_refused():
    """Every family trains; the pure-SSM mamba2 model, once refused, now trains too:
    every one of its parameters gets a finite gradient (tests/test_torch_mamba2_family.py
    holds its loss, gradients and train step against JAX)."""
    ssm2 = dataclasses.replace(get_smoke_config("falcon-mamba-7b"), mamba_version=2)
    for cfg in [get_smoke_config(a) for a in (MOE, VLM, AUDIO, "falcon-mamba-7b",
                                               "zamba2-2.7b")] + [ssm2]:
        model = TM.init_model(torch.Generator().manual_seed(0), cfg)
        assert all(p.requires_grad for p in model.parameters())
    assert set(TM.PORTED.values()) == {("training", "serving")} and "mamba2" in TM.PORTED
    TM._require_ported(ssm2, "training")
    loss, metrics = TM.forward_train(model, params_from_jax(make_batch(ssm2)))
    loss.backward()
    assert sorted(metrics) == ["lm_loss", "loss"]
    assert all(bool(torch.isfinite(p.grad).all()) and bool(p.grad.any())
               for p in model.parameters())
