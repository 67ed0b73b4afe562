"""Functional layers of the LM backbones (counterpart of `repro.models.layers`).

Only what Mamba1 serving needs: RMSNorm, the token embedding and
unembedding with their inits, and the causal depthwise conv in its
full-sequence and single-step forms.  Initializers draw from an explicit
`torch.Generator` and make tensors on its device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Params(nn.Module):
    """A group of named parameters under the JAX pytree's keys.

    The parameters are frozen (``requires_grad=False``): the LM slice
    serves and does not train, so no autograd graph is built.
    """

    def __init__(self, tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def tree(self):
        """The group as a dict of tensors, the JAX pytree's leaf layout."""
        return {name: p.detach() for name, p in self._parameters.items()}


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
