"""GQA attention: training, prefill and cached decode (counterpart of
`repro.models.attention`).

`attention_full` (training) and `attention_prefill` run q, k and v from
`_qkv` through the flash op (`repro_torch.kernels.flash_attention`),
GQA-aware, with no head expansion; the op launches the CUDA kernel on a
GPU and takes its plain version on the CPU, as the reference's
``use_pallas`` branch reaches the Pallas kernel.  `chunked_causal_attention`
and `_expand_kv` are test-only: the reference's jnp re-statement over
query blocks (both its scanned sweep and the ``causal_skip`` one), which
its ``use_pallas=False`` branch and its dense prefill call, kept so the
tests hold the flash op's plain version to it.

Decode: `init_kv_cache` lays out a cache of ``(L, B, C, n_kv, hd)`` (L
layers, or a hybrid's shared-block invocations) with
``C = min(max_len, window)`` (a ring when windowed), `place_kv_in_cache`
lays a prompt's K/V into it, and `attention_decode` attends one token a
stream at per-stream positions.  Unlike the reference, which returns a
new cache, `attention_decode` writes the new K/V into the cache tensors
it is given, in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, attend_block
from repro_torch.models.layers import Params, _trunc_normal, apply_rope


def init_attention(generator, cfg):
    """``wq`` (d, nq, hd), ``wk``/``wv`` (d, nkv, hd), ``wo`` (nq, hd, d)."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(nq * hd)
    dtype = cfg.activation_dtype
    return {
        "wq": _trunc_normal(generator, (d, nq, hd), s, dtype),
        "wk": _trunc_normal(generator, (d, nkv, hd), s, dtype),
        "wv": _trunc_normal(generator, (d, nkv, hd), s, dtype),
        "wo": _trunc_normal(generator, (nq, hd, d), so, dtype),
    }


def _qkv(params: Params, x, positions, cfg):
    """x: (B,S,d) -> q (B,S,nq,hd), k and v (B,S,nkv,hd); q and k rotated."""
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    k = torch.einsum("bsd,dhk->bshk", x, params.wk)
    v = torch.einsum("bsd,dhk->bshk", x, params.wv)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k, n_rep):
    """(B,S,nkv,hd) -> (B,S,nq,hd) by repeating each kv head n_rep times.

    Test-only, with `chunked_causal_attention`.
    """
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def chunked_causal_attention(q, k, v, window: int, chunk: int, causal_skip: bool = False):
    """Causal softmax attention over query blocks of ``chunk`` rows (test-only).

    q, k, v: (B,S,H,hd) with H already expanded to query heads.  window: 0
    for full causal, else the sliding window length.  causal_skip: with no
    window, each query block sees only its causally live key prefix (the
    reference's unrolled sweep) instead of every key.  Returns (B,S,H,hd)
    in k's dtype.  Each block is the flash op's plain version restricted
    to its rows (`attend_block`), float32 inside as the reference.
    """
    S = q.shape[1]
    chunk = min(chunk, S)
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    outs = []
    for r0 in range(0, S, chunk):
        kv_len = min(r0 + chunk, S) if causal_skip and not window else S
        outs.append(attend_block(qT[:, :, r0:r0 + chunk], kT[:, :, :kv_len],
                                 vT[:, :, :kv_len], r0, 0, True, window))
    return torch.cat(outs, dim=2).transpose(1, 2).to(k.dtype)


def _flash(q, k, v, cfg):
    """(B,S,H,hd) q, k, v -> (B,S,nq,hd) through the flash op, causal, windowed."""
    return flash_attention(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=True,
        window=cfg.attn_window,
        bwd_block=cfg.attn_chunk,
    ).transpose(1, 2)


def attention_prefill(params: Params, x, positions, cfg):
    """Prefill attention. x: (B,S,d) -> (y (B,S,d), k, v (B,S,nkv,hd)).

    The reference's dense prefill (model.py:547-560) attends with
    `chunked_causal_attention`; the flash op computes the same function.
    """
    q, k, v = _qkv(params, x, positions, cfg)
    return torch.einsum("bshk,hkd->bsd", _flash(q, k, v, cfg), params.wo), k, v


def attention_full(params: Params, x, positions, cfg):
    """Training attention. x: (B,S,d) -> (B,S,d): prefill's output without its K/V."""
    return attention_prefill(params, x, positions, cfg)[0]


# ------------------------------------------------------------------ decode


def init_kv_cache(cfg, batch, max_len, device, n_layers=None):
    """A zero KV cache: ``k`` and ``v`` (L, B, C, n_kv, hd), C = min(max_len, window).

    L is ``n_layers``, default ``cfg.num_layers``; a hybrid's cache has one
    slot per invocation of its shared block.
    """
    C = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    L = cfg.num_layers if n_layers is None else n_layers
    shape = (L, batch, C, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
    }


def place_kv_in_cache(k, C):
    """Lay out prompt K/V (B,S,nkv,hd) in a capacity-C cache (B,C,nkv,hd).

    Position p lives at slot p % C.  If C >= S the prompt fills slots
    0..S-1 and the rest are zero; else the last C positions are kept,
    rolled so that slot p % C holds position p.
    """
    S = k.shape[1]
    if C >= S:
        return F.pad(k, (0, 0, 0, 0, 0, C - S))
    return torch.roll(k[:, S - C:], shifts=S % C, dims=1)


def attention_decode(params: Params, x, layer_cache, pos, cfg):
    """One token a stream. x: (B,1,d); layer_cache: {k, v} (B,C,nkv,hd); pos: (B,) int.

    ``pos`` is each stream's count of tokens already in context, so
    streams may stand at different depths (continuous batching).  The new
    K/V go to slot ``pos % C`` of a windowed (ring) cache, else to slot
    ``min(pos, C - 1)``, written into ``layer_cache``'s tensors in place.
    Scores and the softmax are float32 as in the reference; the query
    heads are grouped by kv head, (B, n_kv, n_rep, hd), instead of
    repeating the cache n_rep times, which is the same function.
    Returns (y (B,1,d), layer_cache).
    """
    B = x.shape[0]
    pos = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32, device=x.device), (B,))
    q, k_new, v_new = _qkv(params, x, pos[:, None], cfg)
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    C = k_cache.shape[1]
    write = pos % C if cfg.attn_window else torch.clamp(pos, max=C - 1)
    rows = torch.arange(B, device=x.device)
    k_cache[rows, write] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, write] = v_new[:, 0].to(v_cache.dtype)

    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(B, nkv, cfg.num_heads // nkv, hd).float()
    scores = torch.einsum("bgrd,bcgd->bgrc", qg, k_cache.float()) * (1.0 / math.sqrt(hd))
    slot = torch.arange(C, device=x.device)
    if cfg.attn_window:
        # written slots within the window: age 0 is the current token
        age = (write[:, None] - slot[None, :]) % C
        valid = age <= torch.clamp(pos, max=C - 1)[:, None]
    else:
        valid = slot[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], scores, scores.new_full((), NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrc,bcgd->bgrd", w, v_cache.float()).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out.reshape(B, 1, cfg.num_heads, hd), params.wo)
    return y, layer_cache
