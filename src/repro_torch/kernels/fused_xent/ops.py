"""Public fused softmax cross-entropy op, forward only.

``fused_softmax_xent(x, w, labels) -> (T,)`` is the counterpart of
``repro.kernels.fused_xent.ops.fused_softmax_xent``.  Dispatch is by
device: tensors on a GPU launch the CUDA kernel (``csrc/fused_xent.cu``),
tensors on the CPU take the plain version (`ref.softmax_xent_ref`), and
anything else raises.  The kernel masks the token and vocab tails itself,
so unlike the JAX wrapper (``ops.py:34-41``) this one pads nothing and
never shrinks the vocab tile to a divisor of V.

Numerics follow the training loss: each logit is rounded to the operands'
dtype before the float32 logsumexp (see `ref`).  The JAX op has no vjp;
the loss that calls this one (`repro_torch.models.layers.
chunked_softmax_xent`) differentiates its plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.fused_xent.ref import softmax_xent_ref

_ENTRY = {torch.float32: "fused_xent_f32", torch.bfloat16: "fused_xent_bf16"}


@functools.cache
def _kernel(dtype):
    """The kernel's C entry point for ``dtype``, built and loaded at first use."""
    from repro_torch.kernels import load_library

    fn = getattr(load_library("fused_xent.cu"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, w, labels):
    """Run the CUDA kernel; operands are checked by `_check`."""
    T, d = x.shape
    loss = torch.empty(T, dtype=torch.float32, device=x.device)
    labels = labels.to(torch.int32)
    # the C entry point launches on the thread's current device: make it x's
    with torch.cuda.device(x.device):
        err = _kernel(x.dtype)(
            x.data_ptr(), w.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            T, d, w.shape[1], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_xent kernel launch failed: CUDA error {err}")
    fused_softmax_xent.launches += 1
    return loss


def _check(x, w, labels):
    """Device, dtype, contiguity and shape checks."""
    if len({x.device, w.device, labels.device}) != 1:
        raise ValueError("fused_softmax_xent operands must be on one device")
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_softmax_xent takes float32 or bfloat16 x, got {x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"fused_softmax_xent needs w in x's dtype {x.dtype}, got {w.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"fused_softmax_xent needs integer labels, got {labels.dtype}")
    for name, t in (("x", x), ("w", w), ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"fused_softmax_xent needs a contiguous {name}")
    if x.dim() != 2 or w.dim() != 2 or labels.shape != x.shape[:1] or w.shape[0] != x.shape[1]:
        raise ValueError(f"fused_softmax_xent needs x (T, d), w (d, V), labels (T,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(labels.shape)}")


def fused_softmax_xent(x, w, labels):
    """x: (T, d); w: (d, V); labels: (T,) int -> (T,) float32 per-token loss."""
    _check(x, w, labels)
    if x.is_cuda:
        return _launch(x, w, labels)
    if x.device.type == "cpu":
        return softmax_xent_ref(x, w, labels)
    raise NotImplementedError(f"fused_softmax_xent has no kernel for {x.device}")


# Launches of the CUDA kernel in this process; the plain CPU path does not count.
fused_softmax_xent.launches = 0
