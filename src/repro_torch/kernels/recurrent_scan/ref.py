"""Plain-PyTorch versions of the gated linear recurrence.

`linear_recurrence_ref` is the sequential oracle, the counterpart of
``repro.kernels.recurrent_scan.ref.linear_recurrence_ref``: differentiable
by ordinary autograd, it is what tests and ``chip_smoke.py`` hold the op
and its gradients against.

`scan_ref` is the CUDA kernel's plain twin on the kernel's own flattened
layout, in both of its directions.  The op wrapper runs it for tensors on
the CPU, and ``chip_smoke.py`` compares the kernel with it on the card.
"""
from __future__ import annotations

import torch


def linear_recurrence_ref(a, b, h0, reset=None):
    """Sequential oracle: ``a, b: (T, ..., H); h0: (..., H) -> hs (T, ..., H)``.

    ``reset`` (optional ``(T, ...)`` booleans) zeroes the decay of marked
    rows, so the recurrence restarts from ``b_t`` there.
    """
    a = a.float()
    b = b.float()
    if reset is not None:
        a = a * (1.0 - reset[..., None].float())
    h = h0.float()
    hs = []
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        hs.append(h)
    return torch.stack(hs)


def scan_ref(a, b, reset, h0, reverse=False):
    """The kernel's plain twin: ``a, b: (T, D)``, ``reset: (T, B)`` or None.

    Forward: ``h_t = a_eff_t * h_{t-1} + b_t`` from ``h0`` (shape ``(D,)``).
    Reverse (the adjoint): ``h_t = a_eff_{t+1} * h_{t+1} + b_t`` with
    ``h_{T-1} = b_{T-1}``; ``h0`` must be None.  ``a_eff = a * (1 - r)``
    with each batch lane's reset broadcast over its ``D // B`` features.
    """
    T, D = a.shape
    decay = a
    if reset is not None:
        r = reset.to(a.dtype).repeat_interleave(D // reset.shape[1], dim=1)
        decay = a * (1.0 - r)
    out = torch.empty_like(b)
    if not reverse:
        h = h0
        for t in range(T):
            h = decay[t] * h + b[t]
            out[t] = h
    else:
        if h0 is not None:
            raise ValueError("the reverse scan starts from zero; h0 must be None")
        for t in reversed(range(T)):
            h = b[t] if t == T - 1 else decay[t + 1] * h + b[t]
            out[t] = h
    return out
