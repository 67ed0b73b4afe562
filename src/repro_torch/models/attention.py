"""GQA attention for training (counterpart of the training half of
`repro.models.attention`).

`attention_full` is the training path: q, k and v from `_qkv`, then the
flash op (`repro_torch.kernels.flash_attention`), GQA-aware, with no head
expansion; the op launches the CUDA kernel on a GPU and takes its plain
version on the CPU, as the reference's ``use_pallas`` branch reaches the
Pallas kernel.  `chunked_causal_attention` and `_expand_kv` are test-only:
the reference's jnp re-statement over query blocks (both its scanned
sweep and the ``causal_skip`` one), which its ``use_pallas=False`` branch
and its dense prefill call, kept so the tests hold the flash op's plain
version to it until dense prefill is ported.  Decode and its KV cache are
not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attend_block
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


def attention_full(params: Params, x, positions, cfg):
    """Training attention. x: (B,S,d) -> (B,S,d) through the flash op."""
    q, k, v = _qkv(params, x, positions, cfg)
    out = flash_attention(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=True,
        window=cfg.attn_window,
        bwd_block=cfg.attn_chunk,
    ).transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", out, params.wo)
