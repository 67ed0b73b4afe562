"""Plain-PyTorch Mamba1 selective scan: the kernels' oracle and CPU path.

The counterpart of ``repro.kernels.selective_scan.ref.selective_scan_ref``
with the same casts (``ref.py:14-30``): every input is taken to float32, the
recurrence runs in float32, ``y`` goes back to ``x``'s dtype and the final
state stays float32.  `selective_scan_ref_vjp` is autograd through it, the
JAX op's backward (``jax.vjp`` of the oracle, ``ops.py:60-62``).  The op
wrappers run both for tensors on the CPU, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch


def selective_scan_ref(x, delta, A, B, C, D):
    """x, delta: (b,S,di); A: (di,N); B, C: (b,S,N); D: (di,) -> (y, h_final).

    ``h_t = exp(delta_t A) h_{t-1} + (delta_t x_t) outer B_t`` from
    ``h_{-1} = 0``, ``y_t = h_t . C_t + D x_t``.  Returns ``y`` (b,S,di) in
    ``x``'s dtype and ``h_final`` (b,di,N) float32.
    """
    x32 = x.float()
    delta = delta.float()
    B = B.float()
    C = C.float()
    b, S, di = x.shape
    h = x32.new_zeros(b, di, A.shape[-1])
    ys = x32.new_empty(b, S, di)
    for t in range(S):
        d_t = delta[:, t]
        h = torch.exp(d_t[..., None] * A) * h + (d_t * x32[:, t])[..., None] * B[:, t, None, :]
        ys[:, t] = torch.einsum("bdn,bn->bd", h, C[:, t])
    y = ys + x32 * D
    return y.to(x.dtype), h


def selective_scan_ref_vjp(x, delta, A, B, C, D, dy, dh_final):
    """The vjp of `selective_scan_ref` for cotangents ``dy`` (of y) and ``dh_final``.

    Returns (dx, ddelta, dA, dB, dC, dD), each in its input's dtype.  It
    runs the scan again under autograd, as ``jax.vjp`` of the oracle does.
    """
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, delta, A, B, C, D)]
        y, h = selective_scan_ref(*leaves)
        return torch.autograd.grad((y, h), leaves, (dy, dh_final))
