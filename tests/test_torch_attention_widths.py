"""Attention and MoE routing at the widths of Llama-3.1-405B and Kimi-K2, against JAX.

Narrow configs of both packages with the published grouping and head
widths, the weights of the JAX init converted across, on the CPU:

* Kimi-K2's head_dim of 112 (7168 / 64) with its 8 query heads a KV head
  (8 heads of 112 over 1), and Llama-3.1-405B's 16 query heads a KV head
  (16 heads of 128 over 1): the port's training attention against the
  reference's ``use_pallas=False`` branch (the chunked jnp re-statement)
  and its ``use_pallas=True`` branch (the Pallas kernel in interpret mode);
  ``attention_decode`` at per-stream positions; and the flash op's plain
  version against the JAX op in interpret mode, at 2e-5, with no window,
  a window inside S and one at least S, at those widths and at
  Zamba2-2.7B's shared block's 80 (its 32/32 heads narrowed to 4/4) and a
  smoke config's 32 (4/2 heads);
* Kimi-K2's routing, 384 experts, top-8, groups of 512 (capacity 14 a
  group): the dispatch equal exactly, combine and losses at 1e-6, and
  ``moe_ffn``'s output at 1e-5, at prefill and in the decode regime.

On the CPU the flash op takes its plain version; the CUDA kernel at each of
these widths is held against that version on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import KERNEL_HEAD_DIMS, _launch  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402

TOL = 1e-5
FLASH_TOL = 2e-5  # docs/KERNELS.md's float32 flash pin
# (query heads, kv heads, head_dim, d_model): Kimi-K2's 8:1 at 112, Llama-3.1-405B's 16:1 at 128
WIDTHS = {"kimi": (8, 1, 112, 256), "llama405b": (16, 1, 128, 256)}
# the flash op's widths besides: Zamba2-2.7B's shared block (32/32 heads, narrowed to 4/4) at
# 80 and a smoke config's 4/2 at 32 (the attention layer's tests would take them too, at ~1 s a
# case, which the file's time on one thread cannot spare)
FLASH_WIDTHS = {**WIDTHS, "zamba2": (4, 4, 80, 320), "smoke": (4, 2, 32, 128)}


def _attn_configs(which, window=0):
    """A one-layer dense config of both packages at ``which``'s grouping and head width."""
    nq, nkv, hd, d = WIDTHS[which]
    fields = dict(name=f"attn-{which}", arch_type="dense", num_layers=1, d_model=d,
                  num_heads=nq, num_kv_heads=nkv, head_dim=hd, d_ff=64, vocab=32,
                  attn_window=window, attn_chunk=16, dtype="float32")
    jcfg = dataclasses.replace(jax_get_smoke_config("granite-8b"), **fields)
    params = jax.jit(lambda key: JA.init_attention(key, jcfg)[0])(jax.random.key(nq + hd))
    return jcfg, ModelConfig(**fields), params


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("hd", [96, 120, 144])
def test_the_kernel_takes_both_head_widths_and_refuses_others(hd):
    """The wrapper refuses a head_dim with no kernel instance before it touches a card."""
    assert {w[2] for w in FLASH_WIDTHS.values()} <= set(KERNEL_HEAD_DIMS)
    assert hd not in KERNEL_HEAD_DIMS
    q = torch.zeros(1, 2, 8, hd, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim in"):
        _launch(q, q[:, :1].contiguous(), q[:, :1].contiguous(), True, 0)


@pytest.mark.parametrize("which", sorted(WIDTHS))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_training_attention_matches_both_reference_branches(which, use_pallas):
    jcfg, tcfg, params = _attn_configs(which)
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    x = np.random.default_rng(1).normal(size=(2, 40, tcfg.d_model)).astype(np.float32)
    positions = np.arange(40)
    want = jax.jit(lambda p, x: JA.attention_full(p, x, jnp.asarray(positions), jcfg))(
        params, jnp.asarray(x))
    got = TA.attention_full(Params(params_from_jax(params)), torch.from_numpy(x),
                            torch.from_numpy(positions), tcfg)
    assert got.shape == x.shape
    _close(got, want)


@pytest.mark.parametrize("which", sorted(WIDTHS))
@pytest.mark.parametrize("window", [0, 8])
def test_attention_decode_at_per_stream_positions(which, window):
    jcfg, tcfg, params = _attn_configs(which, window)
    C = window or 24
    rng = np.random.default_rng(window + 2)
    shape = (2, C, tcfg.num_kv_heads, tcfg.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([3, 17], np.int32)
    jy, jcache = jax.jit(lambda p, x, c, pos: JA.attention_decode(p, x, c, pos, jcfg))(
        params, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    y, out = TA.attention_decode(Params(params_from_jax(params)), torch.from_numpy(x), cache,
                                 torch.from_numpy(pos), tcfg)
    _close(y, jy)
    for name in ("k", "v"):
        assert out[name] is cache[name]
        _close(out[name], jcache[name])


@pytest.mark.parametrize("which", sorted(FLASH_WIDTHS))
@pytest.mark.parametrize("S,window", [(200, 0), (96, 40), (64, 4096)])
def test_flash_op_matches_the_jax_op(which, S, window):
    nq, nkv, hd, _ = FLASH_WIDTHS[which]
    rng = np.random.default_rng(S)
    q, k, v = (jnp.asarray(rng.normal(size=(1, H, S, hd)), jnp.float32) for H in (nq, nkv, nkv))
    want = jax_flash(q, k, v, causal=True, window=window, block_q=64, block_kv=64,
                     interpret=True)
    before = flash_attention.launches
    got = flash_attention(*params_from_jax([q, k, v]), causal=True, window=window)
    assert flash_attention.launches == before  # the CPU path launches no kernel
    _close(got, want, FLASH_TOL)


# ---------------------------------------------------------------- routing

E, K, GROUP = 384, 8, 512  # Kimi-K2


def test_kimi_capacity():
    assert TMoE.expert_capacity(GROUP, E, K, 1.25) == JMoE.expert_capacity(GROUP, E, K, 1.25) == 14
    assert TMoE.expert_capacity(4, E, K, 1.25) == 1  # decoding 4 streams


def test_routing_over_384_experts_against_jax():
    G = 2
    logits = np.random.default_rng(7).normal(size=(G, GROUP, E)).astype(np.float32) * 2
    C = JMoE.expert_capacity(GROUP, E, K, 1.25)
    jd, jc, jaux, jz = jax.jit(JMoE.top_k_routing, static_argnums=(1, 2))(
        jnp.asarray(logits), K, C)
    d, c, aux, z = TMoE.top_k_routing(torch.from_numpy(logits), K, C)
    assert d.shape == (G, GROUP, E, C)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    _close(c, jc, 1e-6)
    _close(aux, jaux, 1e-6)
    _close(z, jz, 1e-6)
    assert bool((d.sum(dim=1) <= 1).all()) and bool((d.sum(dim=(2, 3)) <= K).all())


@pytest.mark.parametrize("tokens", [(2, 512), (4, 1)])  # two groups at prefill; decode
def test_moe_ffn_over_384_experts_against_jax(tokens):
    fields = dict(name="moe-kimi", arch_type="moe", num_layers=1, d_model=16, num_heads=2,
                  num_kv_heads=2, d_ff=8, vocab=32, num_experts=E, top_k=K,
                  moe_group_size=GROUP, dtype="float32")
    jcfg = dataclasses.replace(jax_get_smoke_config("olmoe-1b-7b"), capacity_factor=1.25,
                               **fields)
    tcfg = ModelConfig(**fields)
    params = jax.jit(lambda key: JMoE.init_moe(key, jcfg)[0])(jax.random.key(3))
    x = np.random.default_rng(9).normal(size=(*tokens, 16)).astype(np.float32)
    jy, jaux, jz = jax.jit(JMoE.moe_ffn, static_argnums=2)(params, jnp.asarray(x), jcfg)
    y, aux, z = TMoE.moe_ffn(Params(params_from_jax(params)), torch.from_numpy(x), tcfg)
    _close(y, jy)
    _close(aux, jaux)
    _close(z, jz)
