"""Llama-3.1-405B and Kimi-K2 serving on the port: their smoke configs against JAX.

The two archs whose published configs the reference shards over a mesh.
The port's configs carry every field, ``sharding="fsdp_tp"`` too, which
only its dry run over a mesh reads; on one card they run unsharded.  On each smoke config in float32, with the
weights of ``repro.models.model.init_model(jax.random.key(0), cfg)``
converted across:

* the configs, the registry and the published parameter counts;
* ``prefill`` then 4 ``decode_step`` calls: logits at 1e-4 and every cache
  leaf at 1e-5 (tests/test_torch_dense_serving.py's tolerances);
* the engine on ragged prompts: token for token the JAX engine and
  sequential generation;
* both launchers with ``--smoke --device cpu``.

tests/test_torch_frontier_training.py holds their training.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro_torch.configs import ARCH_IDS, KNOWN_ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from test_torch_dense_engine import _ragged, _serve_both  # noqa: E402
from test_torch_dense_serving import (  # noqa: E402
    LOGIT_TOL,
    _close,
    _close_caches,
    _jax_fns,
    _models,
)

LLAMA, KIMI = "llama3-405b", "kimi-k2-1t-a32b"
ARCHS = (LLAMA, KIMI)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference_but_sharding(arch):
    """Every field of the published and smoke configs equals the reference's,
    ``sharding`` included (the name is kept from when the port dropped it)."""
    assert set(ARCH_IDS) == set(KNOWN_ARCH_IDS)
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_get_smoke_config(arch))):
        names = {f.name for f in dataclasses.fields(port)}
        assert "sharding" in names
        for name in names:
            assert getattr(port, name) == getattr(ref, name), name
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.flops_param_count() == ref.flops_param_count()


def test_published_widths():
    llama, kimi = get_config(LLAMA), get_config(KIMI)
    assert llama.head_dim == 128 and llama.num_heads // llama.num_kv_heads == 16
    assert kimi.head_dim == 112 and kimi.num_heads // kimi.num_kv_heads == 8
    assert (kimi.num_experts, kimi.top_k, kimi.moe_group_size, kimi.moe_d_ff) == (384, 8, 512,
                                                                                   2048)
    assert llama.param_count() == jax_get_config(LLAMA).param_count()
    assert kimi.param_count() == jax_get_config(KIMI).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_against_jax(arch):
    """A prompt of 40 (Kimi's 80 tokens: one group of 64 and a padded tail), 4 greedy steps."""
    jcfg, params, tcfg, model = _models(arch)
    B, S, steps = 2, 40, 4
    tokens = np.random.default_rng(6).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    jprefill, jdecode = _jax_fns(jcfg, S + steps)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(tokens)})
    logits, cache = TM.prefill(model, torch.from_numpy(tokens), max_len=S + steps)
    assert logits.shape == (B, 1, tcfg.vocab)
    _close(logits, jlogits, LOGIT_TOL)
    _close_caches(cache, jcache)
    tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    for _ in range(steps):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        logits, cache = TM.decode_step(model, cache, torch.from_numpy(tok))
        _close(logits, jlogits, LOGIT_TOL)
        _close_caches(cache, jcache)
        tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_jax_engine_and_sequential(arch):
    tcfg = get_smoke_config(arch)
    prompts, n_new = _ragged(tcfg.vocab), 5
    got, want, engine = _serve_both(arch, prompts, n_new)
    assert got == want and all(len(v) == n_new for v in got.values())
    for i, p in enumerate(prompts):
        one = torch.as_tensor(p[None], dtype=torch.long)
        assert serve.generate(engine.model, one, n_new).tokens[0].tolist() == got[i]


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_on_the_cpu(arch, capsys):
    run = serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "9", "--gen",
                      "4", "--device", "cpu"])
    assert run.tokens.shape == (2, 4)
    assert bool(torch.isfinite(run.logits).all())
    trained = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2", "--seq",
                          "16", "--device", "cpu"])
    assert len(trained.losses) == 2 and all(np.isfinite(trained.losses))
    out = capsys.readouterr().out
    assert "prefill: 2x9" in out and f"arch={get_smoke_config(arch).name}" in out
