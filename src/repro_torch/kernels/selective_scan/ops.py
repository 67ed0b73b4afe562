"""Public Mamba1 selective-scan op, differentiable.

``selective_scan(x, delta, A, B, C, D) -> (y, h_final)`` is the counterpart
of ``repro.kernels.selective_scan.ops.selective_scan``.  Dispatch is by
device: tensors on a GPU launch the CUDA kernel (``csrc/selective_scan.cu``),
tensors on the CPU take the plain version (`ref.selective_scan_ref`), and
anything else raises.  The kernel needs no padding, so unlike the JAX
wrapper (``ops.py:45-55``) this one pads nothing.

Where an input requires grad, the op is a `torch.autograd.Function`, as
the JAX op is a ``jax.custom_vjp`` (``ops.py:40-63``): the forward as
above, the backward `selective_scan_bwd`, the vjp of the oracle for the
cotangents of both outputs.  On a GPU that is a kernel of its own
(``csrc/selective_scan_bwd.cu``); on the CPU it is autograd through
`selective_scan_ref`, which is what the JAX op's backward computes.  Each
gradient comes back in its input's dtype, as ``jax.vjp`` gives it.

Fake inputs (`repro_torch.kernels.is_fake`) get empty outputs of the
kernels' shapes and dtypes, forward and backward, and nothing else.
DTensor inputs run the op on each rank's shards (`_sharded`): the batch
and the channels (``dinner``) may be sharded; A, D, delta and x shard with
the channels, B and C are shared by them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.distributed.sharding import is_dtensor, local_call, sharded_dims
from repro_torch.kernels import is_fake
from repro_torch.kernels.selective_scan.ref import selective_scan_ref, selective_scan_ref_vjp
from repro_torch.roofline.op_cost import custom_op

KERNEL_STATE_SIZES = (4, 8, 16)  # the N the kernels are instantiated for
_ENTRY = {torch.float32: "selective_scan_f32", torch.bfloat16: "selective_scan_bf16"}
_BWD_ENTRY = {torch.float32: "selective_scan_bwd_f32", torch.bfloat16: "selective_scan_bwd_bf16"}


@functools.cache
def _kernel(dtype):
    """The forward kernel's C entry point for ``dtype``, built and loaded at first use."""
    from repro_torch.kernels import load_library

    fn = getattr(load_library("selective_scan.cu"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel(dtype):
    """The backward's C entry point for ``dtype`` and its workspace size, at first use."""
    from repro_torch.kernels import load_library

    lib = load_library("selective_scan_bwd.cu")
    fn = getattr(lib, _BWD_ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.selective_scan_bwd_workspace_bytes
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_size_t
    return fn, size


def _state_size(N):
    if N not in KERNEL_STATE_SIZES:
        raise ValueError(f"selective_scan kernel takes N in {KERNEL_STATE_SIZES}, got {N}")


def _launch(x, delta, A, B, C, D):
    """Run the forward CUDA kernel; operands are checked by `_check`."""
    b, S, di = x.shape
    N = A.shape[-1]
    _state_size(N)
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


def _launch_bwd(x, delta, A, B, C, D, dy, dh_final):
    """Run the backward CUDA kernels; operands are checked by `_check_bwd`."""
    b, S, di = x.shape
    N = A.shape[-1]
    _state_size(N)
    grads = [torch.empty_like(t) for t in (x, delta, A, B, C, D)]
    fn, size = _bwd_kernel(x.dtype)
    workspace = torch.empty(size(b, S, di, N), dtype=torch.uint8, device=x.device)
    dx, ddelta, dA, dB, dC, dD = grads
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), dy.data_ptr(), dh_final.data_ptr(), dx.data_ptr(),
            ddelta.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dD.data_ptr(),
            workspace.data_ptr(), b, S, di, N,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd kernel launch failed: CUDA error {err}")
    selective_scan_bwd.launches += 1
    return tuple(grads)


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


def _check_bwd(x, A, dy, dh_final):
    """The cotangents' checks, beside `_check`'s of the primals."""
    b, S, di = x.shape
    want = {"dy": (dy, x.dtype, (b, S, di)), "dh_final": (dh_final, torch.float32,
                                                         (b, di, A.shape[1]))}
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan_bwd needs a contiguous {name}")


def _forward(x, delta, A, B, C, D):
    (b, S, di), N, e = x.shape, A.shape[1], x.element_size()
    # each input read once, each output written once: x, y and B, C in x's
    # dtype, delta, A, D and h_final float32; per (b, t, d, n) delta*A, the
    # h fma, dx*B and the y fma
    nbytes = b * S * di * (2 * e + 4) + 2 * b * S * N * e + di * N * 4 + di * 4 + b * di * N * 4
    with custom_op("selective_scan", flops=b * S * di * (6 * N + 3), nbytes=nbytes):
        if is_fake(x):
            return torch.empty_like(x), x.new_empty(b, di, N, dtype=torch.float32)
        if x.is_cuda:
            return _launch(x, delta, A, B, C, D)
        if x.device.type == "cpu":
            return selective_scan_ref(x, delta, A, B, C, D)
    raise NotImplementedError(f"selective_scan has no kernel for {x.device}")


class _SelectiveScan(torch.autograd.Function):
    """The scan with `selective_scan_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, delta, A, B, C, D):
        ctx.save_for_backward(x, delta, A, B, C, D)
        return _forward(x, delta, A, B, C, D)

    @staticmethod
    def backward(ctx, dy, dh_final):
        return selective_scan_bwd(*ctx.saved_tensors, dy.contiguous(), dh_final.contiguous())


def selective_scan(x, delta, A, B, C, D):
    """x, delta: (b,S,di); A: (di,N); B, C: (b,S,N); D: (di,) -> (y, h_final).

    ``y`` (b,S,di) is in ``x``'s dtype, ``h_final`` (b,di,N) float32.  x, B
    and C are float32 or bfloat16 (one dtype); delta, A and D float32.
    Differentiable in every input; see the module docstring.
    """
    if is_dtensor(x):  # each rank's call checks its shards
        return _sharded(x, delta, A, B, C, D)
    _check(x, delta, A, B, C, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, delta, A, B, C, D)):
        return _SelectiveScan.apply(x, delta, A, B, C, D)
    return _forward(x, delta, A, B, C, D)


def _sharded(x, delta, A, B, C, D):
    """`selective_scan` on DTensors: the op on each rank's shards.

    x's batch and channel shards are kept (a sequence shard is gathered);
    delta takes x's, A and D its channel shards, B and C its batch shards.
    y comes back laid out as x, h_final (b, di, N) by batch and channels.
    """
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    dims = sharded_dims(x)
    rows = [a for a in names if dims.get(a) == 0]
    chans = [a for a in names if dims.get(a) == 2]

    def place(row_dim=None, chan_dim=None):
        return tuple(Shard(row_dim) if a in rows and row_dim is not None else
                     Shard(chan_dim) if a in chans and chan_dim is not None else Replicate()
                     for a in names)

    xp, ap, bp = place(0, 2), place(chan_dim=0), place(row_dim=0)
    return local_call(lambda *t: selective_scan(*(u.contiguous() for u in t)), mesh,
                      (list(xp), list(place(0, 1))), (xp, xp, ap, bp, bp, ap),
                      x, delta, A, B, C, D)


def selective_scan_bwd(x, delta, A, B, C, D, dy, dh_final):
    """The vjp of `selective_scan` at its inputs for cotangents ``dy`` (b,S,di) in
    ``x``'s dtype and ``dh_final`` (b,di,N) float32.

    Returns (dx, ddelta, dA, dB, dC, dD), each in its input's dtype: the
    CUDA kernel for tensors on a GPU, autograd through the plain version
    (`ref.selective_scan_ref_vjp`) for tensors on the CPU.
    """
    _check(x, delta, A, B, C, D)
    _check_bwd(x, A, dy, dh_final)
    (b, S, di), N, e = x.shape, A.shape[1], x.element_size()
    # each input read once, each output written once: x, dy, dx in x's
    # dtype and delta, ddelta float32 a (b, t, d); B, C, dB, dC in x's dtype
    # a (b, t, n); A, dA, dh_final, D, dD float32.  Per (b, t, d, n) the
    # vjp's 12 flops: the g and h_t fmas, the dB/dC products and du, the
    # ddelta, dA and carry terms
    nbytes = (b * S * di * (3 * e + 8) + 4 * b * S * N * e + 2 * di * N * 4 + b * di * N * 4
              + 2 * di * 4)
    with custom_op("selective_scan_bwd", flops=b * S * di * (12 * N + 6), nbytes=nbytes):
        if is_fake(x):
            return tuple(torch.empty_like(t) for t in (x, delta, A, B, C, D))
        if x.is_cuda:
            return _launch_bwd(x, delta, A, B, C, D, dy, dh_final)
        if x.device.type == "cpu":
            return selective_scan_ref_vjp(x, delta, A, B, C, D, dy, dh_final)
    raise NotImplementedError(f"selective_scan_bwd has no kernel for {x.device}")


# Launches of the CUDA kernels in this process; the plain CPU paths do not count.
selective_scan.launches = 0
selective_scan_bwd.launches = 0
