"""Public flash-attention op: forward kernel, backward through the plain version.

``flash_attention(q, k, v, causal=, window=)`` is the counterpart of
``repro.kernels.flash_attention.ops.flash_attention``.  Dispatch is by
device: tensors on a GPU launch the CUDA kernel (``csrc/flash_attention.cu``),
tensors on the CPU take the plain version (`ref.attention_ref`), and
anything else raises.  The kernel masks keys at positions >= S itself, so
unlike the JAX wrapper (``ops.py:35-53``) this one pads nothing, and a
non-causal call on a ragged S is right.

It is differentiable as the JAX op is (``ops.py:64-73``): the backward is
the vjp of the plain version, recomputed from the saved q, k and v
(`ref.attention_ref_vjp`, ``bwd_block`` query rows at a time).  There is
no backward kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_vjp
from repro_torch.roofline.op_cost import custom_op

KERNEL_HEAD_DIMS = (32, 64, 80, 128)  # the head_dim the kernel is instantiated for
_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}


@functools.cache
def _kernel(dtype):
    """The kernel's C entry point for ``dtype``, built and loaded at first use."""
    from repro_torch.kernels import load_library

    fn = getattr(load_library("flash_attention.cu"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal, window):
    """Run the CUDA kernel; operands are checked by `_check`."""
    B, Hq, S, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {hd}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's bf16 kernel needs q, k and v on 16-byte boundaries")
    out = torch.empty_like(q)
    # the C entry point launches on the thread's current device: make it q's
    with torch.cuda.device(q.device):
        err = _kernel(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, k.shape[1], S, hd, int(causal), window,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def _check(q, k, v, window):
    """Device, dtype, contiguity and shape checks."""
    named = {"q": q, "k": k, "v": v}
    if len({t.device for t in named.values()}) != 1:
        raise ValueError("flash_attention operands must be on one device")
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in named.items():
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention needs {name} in q's dtype {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention needs a contiguous {name}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention needs 4-d {name} (B, H, S, hd)")
    B, Hq, S, hd = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (B, S, hd):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be (B, Hkv, S, hd) "
                         f"for q {tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"query heads {Hq} must be a multiple of kv heads {k.shape[1]}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _live_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps in one (b, h): key <= query if causal,
    key > query - window if windowed."""
    if causal:
        if window and window < S:
            return window * (window + 1) // 2 + (S - window) * window
        return S * (S + 1) // 2
    if window and window < S:
        return S * S - (S - window) * (S - window + 1) // 2
    return S * S


def _forward(q, k, v, causal, window):
    (B, Hq, S, hd), Hkv, e = q.shape, k.shape[1], q.element_size()
    # q, k, v read once, the output written once; two products over the
    # live (query, key) pairs
    nbytes = e * (2 * B * Hq * S * hd + 2 * B * Hkv * S * hd)
    flops = 4 * hd * _live_pairs(S, causal, window) * B * Hq
    with custom_op("flash_attention", flops=flops, nbytes=nbytes):
        if q.is_cuda:
            return _launch(q, k, v, causal, window)
        if q.device.type == "cpu":
            return attention_ref(q, k, v, causal=causal, window=window)
    raise NotImplementedError(f"flash_attention has no kernel for {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, bwd_block):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, bwd_block)
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        causal, window, block = ctx.args
        grads = attention_ref_vjp(*ctx.saved_tensors, g, causal=causal, window=window,
                                  block=block)
        return (*grads, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, bwd_block: int = 512):
    """q: (B,Hq,S,hd); k, v: (B,Hkv,S,hd) -> (B,Hq,S,hd) in q's dtype.

    q, k and v are float32 or bfloat16 (one dtype) and contiguous; query
    head h reads kv head ``h // (Hq // Hkv)``.  ``window`` > 0 keeps the
    keys within ``window`` positions of the query.
    """
    _check(q, k, v, window)
    return _FlashAttention.apply(q, k, v, causal, window, bwd_block)


# Launches of the CUDA kernel in this process; the plain CPU path does not count.
flash_attention.launches = 0
