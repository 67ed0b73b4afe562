"""Plain-PyTorch softmax cross-entropy from hidden states: the kernel's oracle.

``softmax_xent_ref(x, w, labels)`` is the per-token loss
``lse(x·W) − (x·W)[label]`` as the training loss computes it
(``repro.models.layers.softmax_xent_logits`` of ``x @ w``,
``layers.py:101-125``): the product runs in the operands' dtype, so in
bfloat16 each logit is rounded to bfloat16 before the float32 logsumexp
and the gold pick.  In float32 that rounding is a no-op, and this is
``repro.kernels.fused_xent.ref.softmax_xent_ref``, which upcasts first.
`kernel_errors` says how far a kernel's loss lies from it, in units of
what the kernel's roundings allow.
"""
from __future__ import annotations

import torch

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # each token; see `kernel_errors`
MEAN_TOL = 1e-4  # each token on average, beyond one flipped rounding


def softmax_xent_ref(x, w, labels):
    """x: (T, d); w: (d, V); labels: (T,) int -> per-token loss (T,) float32."""
    logits = (x @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return lse - gold


def kernel_errors(got, x, w, labels):
    """``(elem, total, max_abs)`` of a kernel's loss ``got`` against the plain one.

    ``elem`` is the largest token error over its allowance: 1e-4 absolute
    and relative in float32 (docs/KERNELS.md); 2e-2 absolute in bf16, where
    both sides round each logit to bf16 and a sum order that flips the gold
    logit's rounding moves that token's loss by one bf16 step of the logit
    (1.6e-2 below 4).  ``total`` is the summed error over ``MEAN_TOL`` a
    token plus one such flip: a vocab tile left out of the logsumexp shifts
    every token (1.4e-3 at V = 92,544), flips are rare.  The kernel agrees
    when both are <= 1.
    """
    want = softmax_xent_ref(x, w, labels)
    err = (got - want).abs()
    tol = TOL[x.dtype]
    allowed = tol * (1 + want.abs()) if x.dtype == torch.float32 else tol
    flip = 0.0 if x.dtype == torch.float32 else tol
    total = float(err.sum()) / (MEAN_TOL * err.numel() + flip)
    return float((err / allowed).max()), total, float(err.max())
