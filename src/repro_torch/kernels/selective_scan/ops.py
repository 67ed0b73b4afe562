"""Public Mamba1 selective-scan op, forward only.

``selective_scan(x, delta, A, B, C, D) -> (y, h_final)`` is the counterpart
of ``repro.kernels.selective_scan.ops.selective_scan``.  Dispatch is by
device: tensors on a GPU launch the CUDA kernel (``csrc/selective_scan.cu``),
tensors on the CPU take the plain version (`ref.selective_scan_ref`), and
anything else raises.  The kernel needs no padding, so unlike the JAX
wrapper (``ops.py:45-55``) this one pads nothing.

Serving needs no gradient, and the port has no backward yet: the JAX op's
backward is the vjp of its oracle (``ops.py:60-62``), which comes with the
training slice.  A CUDA input that requires grad raises rather than return
a result autograd cannot differentiate.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.roofline.op_cost import custom_op

KERNEL_STATE_SIZES = (4, 8, 16)  # the N the kernel is instantiated for
_ENTRY = {torch.float32: "selective_scan_f32", torch.bfloat16: "selective_scan_bf16"}


@functools.cache
def _kernel(dtype):
    """The kernel's C entry point for ``dtype``, built and loaded at first use."""
    from repro_torch.kernels import load_library

    fn = getattr(load_library("selective_scan.cu"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, delta, A, B, C, D):
    """Run the CUDA kernel; operands are checked by `_check`."""
    b, S, di = x.shape
    N = A.shape[-1]
    if N not in KERNEL_STATE_SIZES:
        raise ValueError(f"selective_scan kernel takes N in {KERNEL_STATE_SIZES}, got {N}")
    if any(t.requires_grad for t in (x, delta, A, B, C, D)):
        raise RuntimeError("selective_scan on CUDA is forward only; an input requires grad")
    y = torch.empty_like(x)
    h_final = torch.empty(b, di, N, dtype=torch.float32, device=x.device)
    # the C entry point launches on the thread's current device: make it x's
    with torch.cuda.device(x.device):
        err = _kernel(x.dtype)(
            x.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), y.data_ptr(), h_final.data_ptr(), b, S, di, N,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    selective_scan.launches += 1
    return y, h_final


def _check(x, delta, A, B, C, D):
    """Device, dtype, contiguity and shape checks."""
    named = {"x": x, "delta": delta, "A": A, "B": B, "C": C, "D": D}
    if len({t.device for t in named.values()}) != 1:
        raise ValueError("selective_scan operands must be on one device")
    if x.dtype not in _ENTRY:
        raise TypeError(f"selective_scan takes float32 or bfloat16 x, got {x.dtype}")
    for name in ("B", "C"):
        if named[name].dtype != x.dtype:
            raise TypeError(f"selective_scan needs {name} in x's dtype {x.dtype}")
    for name in ("delta", "A", "D"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"selective_scan needs float32 {name}, got {named[name].dtype}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"selective_scan needs a contiguous {name}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError("selective_scan needs x (b, S, di) and A (di, N)")
    b, S, di = x.shape
    N = A.shape[1]
    want = {"delta": (b, S, di), "A": (di, N), "B": (b, S, N), "C": (b, S, N), "D": (di,)}
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} {tuple(named[name].shape)} must be {shape}")


def selective_scan(x, delta, A, B, C, D):
    """x, delta: (b,S,di); A: (di,N); B, C: (b,S,N); D: (di,) -> (y, h_final).

    ``y`` (b,S,di) is in ``x``'s dtype, ``h_final`` (b,di,N) float32.  x, B
    and C are float32 or bfloat16 (one dtype); delta, A and D float32.
    """
    _check(x, delta, A, B, C, D)
    (b, S, di), N, e = x.shape, A.shape[1], x.element_size()
    # each input read once, each output written once: x, y and B, C in x's
    # dtype, delta, A, D and h_final float32; per (b, t, d, n) delta*A, the
    # h fma, dx*B and the y fma
    nbytes = b * S * di * (2 * e + 4) + 2 * b * S * N * e + di * N * 4 + di * 4 + b * di * N * 4
    with custom_op("selective_scan", flops=b * S * di * (6 * N + 3), nbytes=nbytes):
        if x.is_cuda:
            return _launch(x, delta, A, B, C, D)
        if x.device.type == "cpu":
            return selective_scan_ref(x, delta, A, B, C, D)
    raise NotImplementedError(f"selective_scan has no kernel for {x.device}")


# Launches of the CUDA kernel in this process; the plain CPU path does not count.
selective_scan.launches = 0
