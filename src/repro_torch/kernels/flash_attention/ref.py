"""Plain-PyTorch attention: the flash kernel's oracle, CPU path and backward.

`attention_ref` is the counterpart of
``repro.kernels.flash_attention.ref.attention_ref`` with the same casts
(``ref.py:13-30``): q, k and v go to float32, the scores are masked with
-1e30 (causal, sliding window, GQA by repeating each kv head), the softmax
and the product with v run in float32, and the output goes back to q's
dtype.  `attention_ref_vjp` is its vjp, recomputed per block of query rows
so that only a (B, H, block, S) slab of scores is alive at a time.
`kernel_errors` says how far a kernel's output lies from `attention_ref`,
in units of what the kernel's roundings allow.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
F32_TOL = 2e-5  # docs/KERNELS.md's float32 pin, each element
BF16_STEP = 2.0**-6  # see `kernel_errors`
ROW_TOL = 1e-2


def attend_block(q, k, v, q0, k0, causal, window):
    """Rows ``q0..`` of `attention_ref` over the keys ``k0..`` it is given.

    q: (B, Hq, Sq, hd) holds query positions ``q0 + i``; k, v: (B, Hkv, Sk,
    hd) hold key positions ``k0 + j``.  Keys the slice leaves out must be
    masked for every row: they would add exact zeros to the softmax.
    """
    hd = q.shape[-1]
    n_rep = q.shape[1] // k.shape[1]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=1)
        v = v.repeat_interleave(n_rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    qpos = torch.arange(q0, q0 + q.shape[2], device=q.device)[:, None]
    kpos = torch.arange(k0, k0 + k.shape[2], device=q.device)[None, :]
    mask = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, scores.new_full((), NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,Hq,S,hd); k,v: (B,Hkv,S,hd) with Hq % Hkv == 0 -> (B,Hq,S,hd)."""
    return attend_block(q, k, v, 0, 0, causal, window)


def attention_ref_vjp(q, k, v, g, *, causal: bool = True, window: int = 0, block: int = 512):
    """(dq, dk, dv) of `attention_ref` at (q, k, v) for the cotangent ``g``.

    The vjp of the plain version, taken ``block`` query rows at a time:
    each block sees only the keys its rows can reach (up to its last row
    when causal, from its first row's window start), which are the keys
    whose softmax weight is not an exact zero.  Like JAX's vjp through
    the reference's casts, the cotangent enters in float32, dk and dv sum
    over the blocks in float32, and each gradient is cast back to its
    input's dtype once.
    """
    S = q.shape[2]
    g = g.float()
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(q)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for r0 in range(0, S, block):
        r1 = min(r0 + block, S)
        k0 = max(0, r0 - window + 1) if window else 0
        k1 = r1 if causal else S
        with torch.enable_grad():
            qb = q[:, :, r0:r1].float().requires_grad_()
            kb = kf[:, :, k0:k1].detach().requires_grad_()
            vb = vf[:, :, k0:k1].detach().requires_grad_()
            out = attend_block(qb, kb, vb, r0, k0, causal, window)
            dqb, dkb, dvb = torch.autograd.grad(out, (qb, kb, vb), g[:, :, r0:r1])
        dq[:, :, r0:r1] = dqb
        dk[:, :, k0:k1] += dkb
        dv[:, :, k0:k1] += dvb
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def kernel_errors(out, q, k, v, *, causal: bool = True, window: int = 0):
    """``(elem, row, max_abs)`` of a kernel's ``out`` against `attention_ref`.

    ``elem`` is the largest element error over its allowance: `F32_TOL`,
    absolute and relative, in float32.  In bf16 the kernel rounds each
    softmax weight to bf16 for P·V (2**-8 relative, so a normalised weight
    moves by up to 2**-7) and both sides round the output to bf16 (at most
    one step, 2**-7 relative, apart): `BF16_STEP` = 2**-6 of the attention
    of |v|, sum_j p_j |v_j|.  ``row`` is the largest ||out - ref|| / ||ref||
    of a query row: independent roundings average out over a row's
    head_dim elements, where a kv tile left out or a causal limit one off
    moves the row as a whole.  The kernel agrees when ``elem <= 1`` and
    ``row <= ROW_TOL``.
    """
    want = attention_ref(q, k, v, causal=causal, window=window).float()
    err = out.float() - want
    if q.dtype == torch.float32:
        allowed = F32_TOL * (1 + want.abs())
    else:
        mass = attention_ref(q.float(), k.float(), v.float().abs(), causal=causal,
                             window=window)
        allowed = BF16_STEP * mass + 1e-6
    elem = float((err.abs() / allowed).max())
    row = float((err.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max())
    return elem, row, float(err.abs().max())
