"""Plain-PyTorch Mamba1 selective scan: the kernels' oracle and CPU path.

The counterpart of ``repro.kernels.selective_scan.ref.selective_scan_ref``
with the same casts (``ref.py:14-30``): every input is taken to float32, the
recurrence runs in float32, ``y`` goes back to ``x``'s dtype and the final
state stays float32.  `selective_scan_ref_vjp` is autograd through it, the
JAX op's backward (``jax.vjp`` of the oracle, ``ops.py:60-62``).  The op
wrappers run both for tensors on the CPU, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.  `selective_scan_bwd_blocked` is the
backward kernel's algebra written out step by step, for the tests.
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


def _sum_in_order(v, dim):
    """Sum over ``dim`` one element after the other, first to last."""
    parts = v.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def selective_scan_bwd_blocked(x, delta, A, B, C, D, dy, dh_final, chunk, lanes):
    """The vjp of `selective_scan_ref` as ``csrc/selective_scan_bwd.cu`` computes it.

    A forward sweep stores the state entering every ``chunk``-th step; the
    chunks are then taken last first: each is rebuilt from its stored state
    with ``a_t = exp(delta_t A)`` and ``a_t h_{t-1}`` kept, and g is carried
    back through them with those, so each (b, t, d, n) takes two
    exponentials.  S is padded to whole chunks with zero steps, and d to
    whole blocks of ``lanes`` lanes with zero lanes, as the kernel stages
    them.  dB_t and dC_t are summed over d in the kernel's order: a block's
    lanes as eight interleaved sums (lanes j, j + 8, j + 16, ... for j = 0 ..
    7) added in turn, then the blocks in order; dA and dD over t last to
    first, then over b in order.  Returns (dx, ddelta, dA, dB, dC, dD), each in its
    input's dtype.
    """
    f32 = torch.float32
    b, S, di = x.shape
    N = A.shape[1]
    nc = -(-S // chunk)
    width = -(-di // lanes) * lanes
    pad_t, pad_d = nc * chunk - S, width - di

    def lane_rows(t):  # (b, S, di) -> (b, nc * chunk, width) float32
        return torch.nn.functional.pad(t.to(f32), (0, pad_d, 0, pad_t))

    xs, dls, dys = lane_rows(x), lane_rows(delta), lane_rows(dy)
    Bs, Cs = (torch.nn.functional.pad(t.to(f32), (0, 0, 0, pad_t)) for t in (B, C))
    Ap = torch.nn.functional.pad(A.to(f32), (0, 0, 0, pad_d))
    Dp = torch.nn.functional.pad(D.to(f32), (0, pad_d))
    u = dls * xs

    # forward sweep: the state entering each chunk
    h = xs.new_zeros(b, width, N)
    entering = [h]
    for t in range((nc - 1) * chunk):
        h = torch.exp(dls[:, t, :, None] * Ap) * h + u[:, t, :, None] * Bs[:, t, None, :]
        if (t + 1) % chunk == 0:
            entering.append(h)

    G = torch.nn.functional.pad(dh_final.to(f32), (0, 0, 0, pad_d))
    dA = xs.new_zeros(b, width, N)
    dD = xs.new_zeros(b, width)
    du = xs.new_zeros(b, nc * chunk, width)
    dda = xs.new_zeros(b, nc * chunk, width)
    vB = xs.new_zeros(b, nc * chunk, width, N)
    vC = xs.new_zeros(b, nc * chunk, width, N)
    for c in reversed(range(nc)):
        h, kept = entering[c], []
        for t in range(c * chunk, (c + 1) * chunk):  # rebuild, a_t and a_t h_{t-1} kept
            a = torch.exp(dls[:, t, :, None] * Ap)
            ah = a * h
            h = u[:, t, :, None] * Bs[:, t, None, :] + ah
            vC[:, t] = dys[:, t, :, None] * h
            kept.append((a, ah))
        for t in reversed(range(c * chunk, (c + 1) * chunk)):  # g carried back
            a, ah = kept[t - c * chunk]
            g = dys[:, t, :, None] * Cs[:, t, None, :] + G
            vB[:, t] = g * u[:, t, :, None]
            du[:, t] = (g * Bs[:, t, None, :]).sum(-1)
            w = g * ah
            dda[:, t] = (w * Ap).sum(-1)
            dA = dA + w * dls[:, t, :, None]
            dD = dD + dys[:, t] * xs[:, t]
            G = g * a

    def over_d(v):  # (b, T, width, N) -> (b, T, N), in the kernel's order
        v = v.unflatten(2, (-1, lanes // 8, 8))
        return _sum_in_order(_sum_in_order(_sum_in_order(v, 3), 3), 2)

    dx = du * dls + dys * Dp
    ddelta = du * xs + dda
    return (dx[:, :S, :di].to(x.dtype), ddelta[:, :S, :di].to(delta.dtype),
            _sum_in_order(dA, 0)[:di].to(A.dtype), over_d(vB)[:, :S].to(B.dtype),
            over_d(vC)[:, :S].to(C.dtype), _sum_in_order(dD, 0)[:di].to(D.dtype))
