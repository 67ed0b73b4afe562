"""Functional layers of the LM backbones (counterpart of `repro.models.layers`).

RMSNorm, the token embedding and unembedding with their inits, RoPE, the
SwiGLU MLP, the softmax cross-entropy loss, and the causal depthwise conv
in its full-sequence and single-step forms.  Initializers draw from an
explicit `torch.Generator` and make tensors on its device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.fused_xent import fused_softmax_xent


def _detach(p):
    return p.detach()


class Params(nn.Module):
    """A group of named parameters under the JAX pytree's keys."""

    def __init__(self, tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    def tree(self, leaf=_detach):
        """The group as a dict, the JAX pytree's leaf layout.

        Each leaf is ``leaf(parameter)``: by default the parameter detached
        (sharing its storage); ``lambda p: p.grad`` gives the gradients.
        """
        return {name: leaf(p) for name, p in self._parameters.items()}


def _trunc_normal(generator, shape, stddev, dtype):
    """A normal truncated at two standard deviations, scaled, then cast."""
    x = torch.empty(shape, device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * stddev).to(dtype)


# ---------------------------------------------------------------- RMSNorm


def init_rmsnorm(d, device):
    """The RMSNorm scale: ones, float32."""
    return torch.ones(d, dtype=torch.float32, device=device)


def rmsnorm(scale, x, eps=1e-6):
    """RMS-normalise the last dim in float32, scale, then cast back."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------- Embedding


def init_embedding(generator, vocab, d, dtype):
    """Token embedding table (vocab, d)."""
    return _trunc_normal(generator, (vocab, d), 1.0, dtype)


def embed(embedding, ids):
    """Rows of ``embedding`` for integer ``ids``."""
    return F.embedding(ids, embedding)


def init_unembed(generator, d, vocab, dtype):
    """Output projection (d, vocab)."""
    return _trunc_normal(generator, (d, vocab), 1.0 / math.sqrt(d), dtype)


# ---------------------------------------------------------------- RoPE


def rope_frequencies(head_dim, theta, device=None):
    """The ``head_dim / 2`` rotation frequencies ``theta ** (-i / half)``."""
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Rotates the two halves of the last dim in float32, then casts back.
    """
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- SwiGLU MLP


def init_mlp(generator, d, d_ff, dtype):
    """SwiGLU weights: ``w_gate``, ``w_up`` (d, d_ff) and ``w_down`` (d_ff, d)."""
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": _trunc_normal(generator, (d, d_ff), s_in, dtype),
        "w_up": _trunc_normal(generator, (d, d_ff), s_in, dtype),
        "w_down": _trunc_normal(generator, (d_ff, d), s_out, dtype),
    }


def mlp(params, x):
    """``(silu(x W_gate) * (x W_up)) W_down`` in the weights' dtype."""
    h = F.silu(x @ params.w_gate) * (x @ params.w_up)
    return h @ params.w_down


# ------------------------------------------------- softmax x-entropy


def softmax_xent_logits(logits, labels):
    """Per-token cross entropy from logits; float32 reductions."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


class _ChunkedXent(torch.autograd.Function):
    """Mean of the masked per-token losses; forward fused, backward chunked."""

    @staticmethod
    def forward(ctx, x, w, labels, mask, chunk):
        B, S, d = x.shape
        losses = fused_softmax_xent(x.reshape(B * S, d), w, labels.reshape(B * S))
        cnt = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(x, w, labels, mask, cnt)
        ctx.chunk = chunk
        return (losses.reshape(B, S) * mask).sum() / cnt

    @staticmethod
    def backward(ctx, g):
        x, w, labels, mask, cnt = ctx.saved_tensors
        S = x.shape[1]
        dlosses = g * mask / cnt  # (B, S) float32
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for s0 in range(0, S, ctx.chunk):
            s1 = min(s0 + ctx.chunk, S)
            with torch.enable_grad():
                xc = x[:, s0:s1].detach().requires_grad_()
                wc = w.detach().requires_grad_()
                losses = softmax_xent_logits(xc @ wc, labels[:, s0:s1])
                dxc, dwc = torch.autograd.grad(losses, (xc, wc), dlosses[:, s0:s1])
            dx[:, s0:s1] = dxc
            dw += dwc
        return dx, dw.to(w.dtype), None, None, None


def chunked_softmax_xent(x, w_unembed, labels, chunk, mask=None):
    """Mean next-token loss without materialising the (B, S, V) logits.

    x: (B, S, d), w_unembed: (d, V), labels: (B, S) int, mask: optional
    (B, S) weighting.  The forward takes the per-token losses from the
    fused xent op in one call over all B·S tokens (the CUDA kernel on a
    GPU, its plain version on the CPU).  The backward is the vjp of the
    plain loss, recomputed per ``chunk`` positions, so peak memory is
    O(B·chunk·V), as the reference's `jax.checkpoint` per chunk keeps it.
    Like the reference (``xc @ w_unembed`` in the operands' dtype), each
    logit is rounded to ``x``'s dtype before the float32 softmax.
    """
    B, S, _ = x.shape
    if mask is None:
        mask = torch.ones(B, S, dtype=torch.float32, device=x.device)
    return _ChunkedXent.apply(x, w_unembed.contiguous(), labels, mask.float(), min(chunk, S))


# ---------------------------------------------------------------- conv1d


def causal_depthwise_conv1d(x, weight, state=None):
    """Depthwise causal conv over time. x: (B,S,C), weight: (C,K).

    If `state` is given it is the last K-1 inputs (B,K-1,C) and x is a single
    step (B,1,C); returns (y, new_state).
    """
    K = weight.shape[-1]
    if state is not None:
        window = torch.cat([state, x], dim=1)  # (B,K,C)
        y = torch.einsum("bkc,ck->bc", window, weight)[:, None]
        return y, window[:, 1:]
    # Sum of K shifted copies, in the reference's order (layers.py:164-171)
    S = x.shape[1]
    y = x * weight[:, K - 1]
    for k in range(K - 1):
        shift = K - 1 - k
        shifted = F.pad(x, (0, 0, shift, 0))[:, :S]
        y = y + shifted * weight[:, k]
    return y
