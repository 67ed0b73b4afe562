"""Dense LM training: data, converter, bfloat16 state and launcher, on the CPU.

On the ``internlm2-1.8b`` smoke config: ``SyntheticTokenDataset`` gives the
JAX package's batches for the same seed; the converter carries the
parameters and the optimizer state of ``launch.steps.make_optimizer``
across and back bit for bit, bfloat16 leaves too; the port's bfloat16
init has the reference's names, shapes and dtypes, and a bfloat16 train
step keeps Adam's ``mu`` in the param dtype and ``nu`` in float32; and the
launcher's ``main`` trains 3 steps on the CPU.  The numerics of the slice are in
tests/test_torch_dense_training.py.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.data.tokens import SyntheticTokenDataset as JaxDataset  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_opt_state_from_jax,
    lm_opt_state_to_jax,
    lm_params_from_jax,
    lm_params_to_jax,
)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticTokenDataset  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import clip_by_global_norm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "internlm2-1.8b"


@functools.cache
def _models(dtype):
    """(JAX cfg, JAX params, port cfg) on the smoke config."""
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    return jcfg, jax.jit(JM.init_model, static_argnums=1)(jax.random.key(0), jcfg), tcfg


def test_synthetic_dataset_gives_the_reference_batches():
    ours, ref = SyntheticTokenDataset(300, 16, 3, seed=7), JaxDataset(300, 16, 3, seed=7)
    np.testing.assert_array_equal(ours.perm, ref.perm)
    r1, r2 = np.random.default_rng(8), np.random.default_rng(8)
    for _ in range(2):
        a, b = ours.sample(r1), ref.sample(r2)
        for name in ("tokens", "labels"):
            np.testing.assert_array_equal(a[name], b[name])
            assert a[name].dtype == np.int32
    a, b = next(iter(ours)), next(iter(ref))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_converter_round_trips_params_and_optimizer_state():
    jcfg, params, tcfg = _models("bfloat16")
    model = lm_params_from_jax(params, tcfg)
    back = lm_params_to_jax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))
    opt_j, _ = jax_make_train_step(jcfg, 3e-4)
    state = opt_j.init(params)
    state = (state[0], state[1]._replace(
        mu=jax.tree_util.tree_map(lambda p: p + 1, state[1].mu)))
    t_state = lm_opt_state_from_jax(state, tcfg)
    assert t_state[0] == () and len(t_state[1].mu["layers"]) == tcfg.num_layers
    for x, y in zip(jax.tree_util.tree_leaves(lm_opt_state_to_jax(t_state)),
                    jax.tree_util.tree_leaves(state)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))


def test_launcher_trains_on_the_cpu(capsys):
    run = train.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
                      "--seq", "32", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=internlm2-1.8b-smoke params=0.6M")
    assert [line.split()[:2] for line in out[1:4]] == [["step", str(i)] for i in range(3)]
    assert out[-1].startswith("loss ")
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert run.losses[-1] < run.losses[0]
    assert int(run.opt_state[1].count) == 3


def test_bfloat16_init_and_optimizer_moments_keep_the_reference_dtypes():
    jcfg, params, tcfg = _models("bfloat16")
    model = TM.init_model(torch.Generator().manual_seed(0), tcfg)
    got = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), lm_params_to_jax(model))
    assert got == jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), params)
    opt, step = make_train_step(tcfg, 3e-4)
    state = opt.init(model.tree())
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 25)).astype(np.int32)
    batch = params_from_jax({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    model, state, metrics = step(model, state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    adam = state[1]
    assert {t.dtype for t in tree_leaves(adam.mu)} == {torch.bfloat16, torch.float32}
    for m, p in zip(tree_leaves(adam.mu), tree_leaves(model.tree())):
        assert m.dtype == p.dtype  # mu in the param dtype, as the reference
    assert {t.dtype for t in tree_leaves(adam.nu)} == {torch.float32}
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16, torch.float32}


def test_clip_promotes_bfloat16_gradients_as_jax_does():
    """JAX's bf16 gradient times the float32 clip factor is float32."""
    rng = np.random.default_rng(9)
    grads = {"a": rng.normal(size=(5, 7)) * 3, "b": rng.normal(size=(11,))}
    jgrads = jax.tree_util.tree_map(lambda x: jax.numpy.asarray(x, jax.numpy.bfloat16), grads)
    want, _ = jax_optim.clip_by_global_norm(1.0).update(jgrads, ())
    got, _ = clip_by_global_norm(1.0).update(params_from_jax(jgrads), ())
    for name in grads:
        assert got[name].dtype == torch.float32 and want[name].dtype == jax.numpy.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-6)

