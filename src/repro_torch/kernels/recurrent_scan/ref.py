"""Plain-PyTorch versions of the gated linear recurrence.

`linear_recurrence_ref` is the sequential oracle, the counterpart of
``repro.kernels.recurrent_scan.ref.linear_recurrence_ref``: differentiable
by ordinary autograd, it is what tests and ``chip_smoke.py`` hold the op
and its gradients against.

`scan_ref` is the CUDA kernel's plain twin on the kernel's own flattened
layout, in both of its directions.  The op wrapper runs it for tensors on
the CPU, and ``chip_smoke.py`` compares the kernel with it on the card.

`chunked_scan_ref` does the kernel's own algebra (chunks scanned from zero,
their products of decays, the carry combined chunk by chunk in order, the
fix-up) in plain PyTorch.  Only tests and ``chip_smoke.py`` use it.
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


def _decay(a, reset, reverse):
    """``a_eff`` (forward) or ``a_eff`` shifted one step up, 0 last (reverse)."""
    T, D = a.shape
    decay = a
    if reset is not None:
        r = reset.to(a.dtype).repeat_interleave(D // reset.shape[1], dim=1)
        decay = a * (1.0 - r)
    if reverse:
        decay = torch.cat([decay[1:], decay.new_zeros(1, D)])
    return decay


def scan_ref(a, b, reset, h0, reverse=False):
    """The kernel's plain twin: ``a, b: (T, D)``, ``reset: (T, B)`` or None.

    Forward: ``h_t = a_eff_t * h_{t-1} + b_t`` from ``h0`` (shape ``(D,)``).
    Reverse (the adjoint): ``h_t = a_eff_{t+1} * h_{t+1} + b_t`` with
    ``h_{T-1} = b_{T-1}``; ``h0`` must be None.  ``a_eff = a * (1 - r)``
    with each batch lane's reset broadcast over its ``D // B`` features.
    """
    T = a.shape[0]
    decay = _decay(a, reset, False)
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


def chunked_scan_ref(a, b, reset, h0, chunk, reverse=False):
    """`scan_ref`'s recurrence computed as ``csrc/recurrent_scan.cu`` does.

    Time is cut into chunks of ``chunk`` steps (the last padded with
    identity steps: decay 1, ``b`` 0).  Each chunk is scanned from zero in
    the direction of the recurrence, keeping its local states and the
    running products of its decays; the carry into each chunk is folded
    from ``h0`` (forward) or 0 (reverse), chunk by chunk in order,
    ``c <- P_j * c + H_j`` with the chunk's whole product and last local
    state; then ``h_t = local_t + product_t * carry_in``.
    """
    if reverse and h0 is not None:
        raise ValueError("the reverse scan starts from zero; h0 must be None")
    T, D = a.shape
    n = -(-T // chunk)
    pad = n * chunk - T
    decay = torch.cat([_decay(a, reset, reverse), a.new_ones(pad, D)]).reshape(n, chunk, D)
    bb = torch.cat([b, b.new_zeros(pad, D)]).reshape(n, chunk, D)
    steps = range(chunk - 1, -1, -1) if reverse else range(chunk)
    loc, prod = b.new_zeros(n, D), b.new_ones(n, D)
    locs, prods = torch.empty_like(bb), torch.empty_like(bb)
    for i in steps:
        loc = decay[:, i] * loc + bb[:, i]
        prod = prod * decay[:, i]
        locs[:, i], prods[:, i] = loc, prod
    last = 0 if reverse else chunk - 1
    c = b.new_zeros(D) if h0 is None else h0
    out = torch.empty_like(bb)
    for j in (range(n - 1, -1, -1) if reverse else range(n)):
        out[j] = locs[j] + prods[j] * c
        c = prods[j, last] * c + locs[j, last]
    return out.reshape(n * chunk, D)[:T]
