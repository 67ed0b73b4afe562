"""The serving engine and launcher on attention models, against the JAX package.

On the ``internlm2-1.8b`` (dense) and ``olmoe-1b-7b`` (moe) smoke configs,
with the weights of ``repro.models.model.init_model(jax.random.key(0),
cfg)`` converted across:

* the engine on tests/test_serving.py's ragged prompts (12, 9, 15 tokens;
  2 slots, prompt capacity 16): token for token the JAX engine's outputs
  and sequential generation;
* ``eos_id`` stopping a request, as the JAX engine stops it;
* continuous refill: more requests than slots drain through slot reuse;
* the prompt capacity;
* ``launch.serve.main`` for ``granite-8b --smoke --device cpu``, and the
  launcher's greedy tokens against JAX prefill and decode.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402


@functools.cache
def _models(arch):
    """(JAX cfg, JAX params, port cfg, port model) on ``arch``'s smoke config."""
    jcfg, tcfg = jax_get_smoke_config(arch), get_smoke_config(arch)
    params = jax.jit(JM.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    return jcfg, params, tcfg, lm_params_from_jax(params, tcfg)


def _serve_both(arch, prompts, n_new, slots=2, capacity=16, eos=None, jax_too=True):
    """The port's and (``jax_too``) the JAX engine's outputs, {uid: tokens}, on ``prompts``."""
    jcfg, params, _, model = _models(arch)
    teng = ServingEngine(model, max_slots=slots, prompt_capacity=capacity,
                         max_new_tokens=n_new, device="cpu")
    for i, p in enumerate(prompts):
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=n_new, eos_id=eos))
    got = {r.uid: r.output for r in teng.run_until_drained()}
    want = None
    if jax_too:
        jeng = JaxEngine(jcfg, params, max_slots=slots, prompt_capacity=capacity,
                         max_new_tokens=n_new)
        for i, p in enumerate(prompts):
            jeng.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=n_new, eos_id=eos))
        want = {r.uid: r.output for r in jeng.run_until_drained()}
    return got, want, teng


def _ragged(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (12, 9, 15)]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b"])
def test_engine_matches_the_jax_engine_and_sequential(arch):
    _, _, tcfg, model = _models(arch)
    prompts, n_new = _ragged(tcfg.vocab), 6
    got, want, engine = _serve_both(arch, prompts, n_new)
    assert got == want and all(len(v) == n_new for v in got.values())
    assert engine.cache["kv"]["k"].shape[2] == 16 + n_new  # prompt capacity + new tokens
    for i, p in enumerate(prompts):
        one = torch.as_tensor(p[None], dtype=torch.long)
        assert serve.generate(model, one, n_new).tokens[0].tolist() == got[i]


def test_eos_stops_a_request():
    _, _, tcfg, _ = _models("internlm2-1.8b")
    prompts = _ragged(tcfg.vocab)
    free, _, _ = _serve_both("internlm2-1.8b", prompts, 6, jax_too=False)
    eos = free[0][2]  # a decoded token of request 0 (the prefill's token is never checked)
    got, want, _ = _serve_both("internlm2-1.8b", prompts, 6, eos=eos)
    assert got == want
    assert got[0] == free[0][:free[0].index(eos, 1) + 1]
    for uid, out in free.items():
        cut = out.index(eos, 1) + 1 if eos in out[1:] else len(out)
        assert got[uid] == out[:cut]


def test_continuous_refill():
    """More requests than slots: the queue drains through slot reuse (tests/test_serving.py:57)."""
    _, _, tcfg, _ = _models("internlm2-1.8b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab, (5,)).astype(np.int32) for _ in range(5)]
    got, want, engine = _serve_both("internlm2-1.8b", prompts, 3, capacity=8)
    assert got == want
    assert sorted(got) == [0, 1, 2, 3, 4] and all(len(v) == 3 for v in got.values())
    assert all(s is None for s in engine.slots) and not engine.queue


def test_prompt_capacity_is_enforced():
    _, _, tcfg, model = _models("olmoe-1b-7b")
    engine = ServingEngine(model, max_slots=2, prompt_capacity=8, max_new_tokens=4,
                           device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        engine.submit(Request(uid=0, prompt=np.zeros(9, np.int32)))
    engine.submit(Request(uid=1, prompt=np.zeros(8, np.int32), max_new_tokens=4))
    assert len(engine.run_until_drained()[0].output) == 4


def test_launcher_main_on_granite(capsys):
    run = serve.main(["--arch", "granite-8b", "--smoke", "--batch", "2", "--prompt-len", "11",
                      "--gen", "5", "--device", "cpu"])
    assert run.tokens.shape == (2, 5)
    assert bool(((run.tokens >= 0) & (run.tokens < get_smoke_config("granite-8b").vocab)).all())
    assert bool(torch.isfinite(run.logits.float()).all())
    out = capsys.readouterr().out
    assert "prefill: 2x11" in out and "tok/s" in out and "sample stream 0:" in out


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
def test_launcher_greedy_tokens_match_the_jax_model(arch):
    """The launcher's generate on converted weights = JAX prefill (max_len S + gen) + decode."""
    jcfg, params, tcfg, model = _models(arch)
    prompts = serve.make_inputs(tcfg, 2, 10, 3, "cpu")["tokens"]
    run = serve.generate(model, prompts, 4)
    jlogits, jcache = jax.jit(lambda p, b: JM.prefill(p, b, jcfg, max_len=14))(
        params, {"tokens": jnp.asarray(prompts.numpy(), jnp.int32)})
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg))
    for _ in range(3):
        jlogits, jcache = decode(params, jcache, tok)
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(run.tokens.numpy(), np.concatenate(want, 1))
