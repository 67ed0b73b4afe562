"""Public gated-linear-recurrence op with its gradient.

``linear_recurrent_scan(a, b, h0, reset)`` evaluates

    h_t = a_t * (1 - reset_t) * h_{t-1} + b_t

over a leading time axis: the whole-trajectory unroll of
`repro_torch.nn.LinearScannedRNN`, with episode-boundary resets folded
into the decay.  The counterpart of
``repro.kernels.recurrent_scan.ops.linear_recurrent_scan``.

Dispatch is by device: tensors on a GPU launch the CUDA kernel
(``csrc/recurrent_scan.cu``), tensors on the CPU take the kernel's plain
twin (`ref.scan_ref`).  The backward pass follows the reference
(``repro/kernels/recurrent_scan/ops.py:106-123``): the adjoint
``lam_t = g_t + a_eff_{t+1} * lam_{t+1}`` is the same recurrence run
backwards in time, so it goes through the same kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.recurrent_scan.ref import scan_ref
from repro_torch.roofline.op_cost import custom_op

KERNEL_CHUNK = 16  # steps a chunk in csrc/recurrent_scan.cu (kChunk, checked in _kernel)


@functools.cache
def _kernel():
    """The kernel's C entry point, built and loaded at first use."""
    from repro_torch.kernels import load_library

    lib = load_library("recurrent_scan.cu")
    lib.linear_scan_chunk.restype = ctypes.c_int
    if lib.linear_scan_chunk() != KERNEL_CHUNK:
        raise RuntimeError(f"recurrent_scan.cu scans chunks of {lib.linear_scan_chunk()} steps, "
                           f"ops.KERNEL_CHUNK says {KERNEL_CHUNK}")
    fn = lib.linear_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(a, b, reset, h0, reverse: bool):
    """Run the CUDA kernel on flattened ``(T, D)`` operands."""
    T, D = a.shape
    H = D // reset.shape[1] if reset is not None else 1
    out = torch.empty_like(b)
    # the C entry point launches on the thread's current device: make it a's
    with torch.cuda.device(a.device):
        err = _kernel()(
            a.data_ptr(), b.data_ptr(),
            reset.data_ptr() if reset is not None else None,
            h0.data_ptr() if h0 is not None else None,
            out.data_ptr(), T, D, H, int(reverse),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"recurrent_scan kernel launch failed: CUDA error {err}")
    linear_recurrent_scan.launches += 1
    return out


def _check(a, b, reset, h0):
    """Device, dtype, contiguity and shape checks shared by both directions."""
    tensors = [a, b] + [t for t in (reset, h0) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("recurrent_scan operands must be on one device")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"recurrent_scan needs float32 {name}, got {t.dtype}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"recurrent_scan needs a contiguous {name}")
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    if h0 is not None and h0.shape != a.shape[1:]:
        raise ValueError(f"h0 {tuple(h0.shape)} must be a.shape[1:]")
    if reset is not None:
        if reset.dtype != torch.bool or not reset.is_contiguous():
            raise TypeError("recurrent_scan needs a contiguous bool reset")
        if reset.shape != a.shape[:-1]:
            raise ValueError(f"reset {tuple(reset.shape)} must be a.shape[:-1]")
    if a.dim() < 2:
        raise ValueError("recurrent_scan needs a (T, ..., H) input")


def _scan(a, b, reset, h0, reverse=False):
    """One scan over ``(T, ..., H)`` operands, on the device they lie on."""
    _check(a, b, reset, h0)
    T = a.shape[0]
    D = math.prod(a.shape[1:])
    # reset stays (T, B): the kernel broadcasts it over the H features of
    # each batch lane itself, where the reference's wrapper materialises a
    # (T, B*H) mask (ops.py:82)
    flat = (
        a.reshape(T, D), b.reshape(T, D),
        reset.reshape(T, -1) if reset is not None else None,
        h0.reshape(D) if h0 is not None else None,
    )
    # each input read once, the output written once (a, b, out float32; h0;
    # the reset mask in bytes); one multiply-add an element and step
    nbytes = (3 * T * D * 4 + (D * 4 if h0 is not None else 0)
              + (flat[2].numel() if reset is not None else 0))
    with custom_op("recurrent_scan", flops=2 * T * D, nbytes=nbytes):
        if a.is_cuda:
            out = _launch(*flat, reverse)
        elif a.device.type == "cpu":
            out = scan_ref(*flat, reverse=reverse)
        else:
            raise NotImplementedError(f"recurrent_scan has no kernel for {a.device}")
    return out.reshape(a.shape)


class _LinearScan(torch.autograd.Function):
    """The op with the reference's custom backward (ops.py:106-123)."""

    @staticmethod
    def forward(ctx, a, b, h0, reset):
        hs = _scan(a, b, reset, h0)
        ctx.save_for_backward(a, h0, hs, reset)
        return hs

    @staticmethod
    def backward(ctx, g):
        a, h0, hs, reset = ctx.saved_tensors
        keep = None if reset is None else 1.0 - reset[..., None].to(a.dtype)
        lam = _scan(a, g.contiguous(), reset, None, reverse=True)
        h_prev = torch.cat([h0[None], hs[:-1]], 0)
        da_eff = lam * h_prev
        a0_eff = a[0] if keep is None else a[0] * keep[0]
        da = da_eff if keep is None else da_eff * keep
        return da, lam, a0_eff * lam[0], None


def linear_recurrent_scan(a, b, h0, reset=None):
    """a, b: (T, ..., H); h0: (..., H); reset: (T, ...) bools -> hs (T, ..., H).

    Inclusive outputs: ``hs[t]`` is the state after absorbing row ``t``
    (the final carry is ``hs[-1]``).  ``reset`` rows restart the recurrence
    from ``b_t`` alone.  Differentiable in ``a``, ``b`` and ``h0``.
    """
    return _LinearScan.apply(a, b, h0, reset)


# Launches of the CUDA kernel in this process (forward and backward alike);
# the plain CPU path does not count.
linear_recurrent_scan.launches = 0
