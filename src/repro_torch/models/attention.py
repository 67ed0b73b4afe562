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
it is given, in place.  On DTensors (a sharded run) decode goes through
`_sharded_decode` and the flash op through its sharded call.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    einsum,
    is_dtensor,
    local_call,
    shard_index,
    sharded_dims,
    sharded_zeros,
    with_logical_constraint,
)
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


# `init_attention`'s logical axes (attention.py:41-46)
ATTENTION_AXES = {
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
}


def _qkv(params: Params, x, positions, cfg):
    """x: (B,S,d) -> q (B,S,nq,hd), k and v (B,S,nkv,hd); q and k rotated."""
    q = einsum("bsd,dhk->bshk", x, params.wq)
    k = einsum("bsd,dhk->bshk", x, params.wk)
    v = einsum("bsd,dhk->bshk", x, params.wv)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = with_logical_constraint(q, ("batch", None, "heads", None))
    k = with_logical_constraint(k, ("batch", None, "kv_heads", None))
    v = with_logical_constraint(v, ("batch", None, "kv_heads", None))
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
    y = einsum("bshk,hkd->bsd", _flash(q, k, v, cfg), params.wo)
    return with_logical_constraint(y, ("batch", None, "embed")), k, v


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
    axes = kv_cache_axes(cfg)
    return {name: sharded_zeros(shape, axes[name], dtype=cfg.activation_dtype, device=device)
            for name in ("k", "v")}


def kv_cache_axes(cfg):
    """The cache's logical axes (attention.py:190-195): its sequence dim is
    ``kv_seq`` under ``cfg.shard_kv_seq``, unsharded otherwise."""
    seq = "kv_seq" if cfg.shard_kv_seq else None
    return {"k": (None, "batch", seq, "kv_heads", None),
            "v": (None, "batch", seq, "kv_heads", None)}


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


def _valid_slots(slot, write, pos, C, cfg):
    """(B, slots) mask of the cache slots a stream attends to at ``pos``."""
    if cfg.attn_window:
        # written slots within the window: age 0 is the current token
        age = (write[:, None] - slot[None, :]) % C
        return age <= torch.clamp(pos, max=C - 1)[:, None]
    return slot[None, :] <= pos[:, None]


def _decode_scores(qg, k, valid):
    """Float32 scores of grouped queries qg (B, g, r, hd) over cache slots k
    (B, C, g, hd), those outside ``valid`` (B, C) at `NEG_INF`."""
    scores = torch.einsum("bgrd,bcgd->bgrc", qg, k.float()) * (1.0 / math.sqrt(qg.shape[-1]))
    return torch.where(valid[:, None, None, :], scores, scores.new_full((), NEG_INF))


def _decode_attend(qg, k, v, valid):
    """Decode attention of qg (B, g, r, hd) over the slots of k, v (B, C, g,
    hd) that ``valid`` (B, C) keeps; (B, g, r, hd) in float32."""
    w = torch.softmax(_decode_scores(qg, k, valid), dim=-1)
    return torch.einsum("bgrc,bcgd->bgrd", w, v.float())


def _sharded_decode(q, k_new, v_new, k_cache, v_cache, pos, cfg):
    """`attention_decode`'s cache write and attention on DTensors, per rank.

    The cache keeps its layout (its shards are written in place): batch
    shards, kv-head shards, and with ``cfg.shard_kv_seq`` sequence shards.
    q keeps its batch shards and its head shards over the axes the cache's
    sequence does not use (over those q's heads are gathered: every rank
    there attends all heads over its slots).  A rank whose query heads
    share replicated kv heads reads only theirs (`kv_heads_read`).  Only
    the rank holding a stream's write slot writes it.  Over sequence
    shards each rank's softmax is partial: two all-reduces combine them,
    the max of the scores, then the sum of the exponentials beside their
    weighted values, so the cache is never gathered.  Returns (B, 1, nq,
    hd) in q's dtype.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.flash_attention.ops import kv_heads_read

    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    cd, qd = sharded_dims(k_cache), sharded_dims(q)
    batch_axes = [a for a in names if cd.get(a) == 0]
    seq_axes = [a for a in names if cd.get(a) == 1]
    kvh_axes = [a for a in names if cd.get(a) == 2]
    head_axes = [a for a in names if qd.get(a) == 2 and a not in seq_axes]
    if any(a not in head_axes for a in kvh_axes):
        raise ValueError("a cache sharded over kv heads needs its query heads sharded alike")
    cache_place = tuple(k_cache.placements)
    q_place = tuple(Shard(0) if a in batch_axes else Shard(2) if a in head_axes else Replicate()
                    for a in names)
    new_place = tuple(Shard(0) if a in batch_axes else Shard(2) if a in kvh_axes else Replicate()
                      for a in names)
    pos_place = tuple(Shard(0) if a in batch_axes else Replicate() for a in names)
    heads, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    index, shards = shard_index(mesh, head_axes)
    lo, hi = (0, nkv) if kvh_axes else kv_heads_read(heads, nkv, shards, index)
    seq_index, seq_shards = shard_index(mesh, seq_axes)
    groups = [mesh.get_group(a) for a in seq_axes]

    def run(ql, kn, vn, kc, vc, p):
        Bl, Cl = kc.shape[0], kc.shape[1]
        C, c0 = Cl * seq_shards, seq_index * Cl
        write = p % C if cfg.attn_window else torch.clamp(p, max=C - 1)
        local = torch.clamp(write - c0, 0, Cl - 1)
        mine = ((write >= c0) & (write < c0 + Cl))[:, None, None]
        rows = torch.arange(Bl, device=kc.device)
        kc[rows, local] = torch.where(mine, kn[:, 0].to(kc.dtype), kc[rows, local])
        vc[rows, local] = torch.where(mine, vn[:, 0].to(vc.dtype), vc[rows, local])
        kh, vh = (kc, vc) if kvh_axes else (kc[:, :, lo:hi], vc[:, :, lo:hi])
        g = kh.shape[2]
        qg = ql.reshape(Bl, g, ql.shape[2] // g, hd).float()
        valid = _valid_slots(c0 + torch.arange(Cl, device=kc.device), write, p, C, cfg)
        if not groups:
            out = _decode_attend(qg, kh, vh, valid)
        else:
            scores = _decode_scores(qg, kh, valid)
            top = scores.amax(-1, keepdim=True)
            for grp in groups:
                dist.all_reduce(top, op=dist.ReduceOp.MAX, group=grp)
            e = torch.exp(scores - top)
            part = torch.cat([torch.einsum("bgrc,bcgd->bgrd", e, vh.float()),
                              e.sum(-1, keepdim=True)], dim=-1)
            for grp in groups:
                dist.all_reduce(part, op=dist.ReduceOp.SUM, group=grp)
            out = part[..., :hd] / part[..., hd:]
        return out.to(ql.dtype).reshape(Bl, 1, ql.shape[2], hd)

    return local_call(run, mesh, list(q_place),
                      (q_place, new_place, new_place, cache_place, cache_place, pos_place),
                      q, k_new, v_new, k_cache, v_cache, pos)


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
    hd = cfg.head_dim
    if is_dtensor(q):
        out = _sharded_decode(q, k_new, v_new, layer_cache["k"], layer_cache["v"], pos, cfg)
        y = einsum("bshk,hkd->bsd", out, params.wo)
        return with_logical_constraint(y, ("batch", None, "embed")), layer_cache
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    C = k_cache.shape[1]
    write = pos % C if cfg.attn_window else torch.clamp(pos, max=C - 1)
    rows = torch.arange(B, device=x.device)
    k_cache[rows, write] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, write] = v_new[:, 0].to(v_cache.dtype)

    nkv = cfg.num_kv_heads
    qg = q.reshape(B, nkv, cfg.num_heads // nkv, hd).float()
    valid = _valid_slots(torch.arange(C, device=x.device), write, pos, C, cfg)
    out = _decode_attend(qg, k_cache, v_cache, valid).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out.reshape(B, 1, cfg.num_heads, hd), params.wo)
    return y, layer_cache
