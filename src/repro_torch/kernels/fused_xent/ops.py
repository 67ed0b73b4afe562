"""Public fused softmax cross-entropy op, forward only.

``fused_softmax_xent(x, w, labels) -> (T,)`` is the counterpart of
``repro.kernels.fused_xent.ops.fused_softmax_xent``.  Dispatch is by
device: tensors on a GPU launch the CUDA kernel (``csrc/fused_xent.cu``),
tensors on the CPU take the plain version (`ref.softmax_xent_ref`), and
anything else raises.  The kernel masks the token and vocab tails itself,
so unlike the JAX wrapper (``ops.py:34-41``) it never pads T or shrinks
the vocab tile to a divisor of V.  The bf16 kernel reads x and W through
TMA, which needs 16-byte row strides: `tma_operands` pads d and W's rows
to multiples of 8 with zeros where they are not (the training shape
copies nothing), and the kernel masks columns >= V.  It cuts the vocab
into `vocab_splits`; each launch of the op then runs two kernels, the
product-and-fold over (split, token tile) blocks and a combine over the
splits, counted in ``launches`` and ``combine_launches``.

Fake inputs (`repro_torch.kernels.is_fake`) get an empty (T,) float32
loss and nothing else.  DTensor inputs run the op on each rank's shards
(`_sharded`): tokens sharded over some mesh axes, the vocab over others,
each rank's partial logsumexp and label logit combined across the vocab's.

Numerics follow the training loss: each logit is rounded to the operands'
dtype before the float32 logsumexp (see `ref`).  The JAX op has no vjp;
the loss that calls this one (`repro_torch.models.layers.
chunked_softmax_xent`) differentiates its plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.distributed.sharding import (
    is_dtensor,
    local_call,
    shard_index,
    sharded_dims,
)
from repro_torch.kernels import is_fake
from repro_torch.kernels.fused_xent.ref import softmax_xent_ref
from repro_torch.roofline.op_cost import custom_op

_DTYPES = (torch.float32, torch.bfloat16)
# (pointer arguments, int arguments) of each C entry point; a stream follows
_ARGS = {"fused_xent_f32": (4, 3), "fused_xent_bf16": (4, 6), "fused_xent_combine": (2, 2)}
TOKEN_TILE, VOCAB_TILE = 128, 256  # the bf16 kernel's block of tokens, tile of columns
WAVES = 8  # blocks to aim for, in multiples of the card's SMs


@functools.cache
def _kernel(name):
    """The C entry point ``name``, built and loaded at first use."""
    from repro_torch.kernels import load_library

    fn = getattr(load_library("fused_xent.cu"), name)
    n_ptr, n_int = _ARGS[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def vocab_splits(T: int, V: int, sms: int) -> tuple[int, int]:
    """``(splits, tiles_per_split)`` of the bf16 kernel's vocab tiles.

    Enough (split, token tile) blocks for about `WAVES` waves on ``sms``
    SMs, each split a run of whole `VOCAB_TILE` tiles and none empty.  At
    the training shape (16,384 tokens, V = 92,544) on 132 SMs: 9 splits
    of 41 tiles, so the blocks running at once share ~15 token tiles of x.
    """
    n_tt = -(-T // TOKEN_TILE)
    n_vt = -(-V // VOCAB_TILE)
    per = -(-n_vt // min(n_vt, -(-WAVES * sms // n_tt)))
    return -(-n_vt // per), per


def tma_operands(x, w):
    """``(x, w)`` with d and W's row length padded with zeros to multiples of 8.

    TMA reads rows at 16-byte strides from 16-byte aligned starts; an
    operand that already has them is returned as it is.  The zero columns
    of x and rows of W add nothing to a logit; the kernel masks W's
    columns >= V.
    """
    (T, d), V = x.shape, w.shape[1]
    d8, v8 = -(-d // 8) * 8, -(-V // 8) * 8
    if d8 != d or x.data_ptr() % 16:
        padded = x.new_zeros(T, d8)
        padded[:, :d] = x
        x = padded
    if (d8, v8) != (d, V) or w.data_ptr() % 16:
        padded = w.new_zeros(d8, v8)
        padded[:d, :V] = w
        w = padded
    return x, w


def _call(name, *args):
    err = _kernel(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _launch(x, w, labels):
    """Run the CUDA kernels; operands are checked by `_check`."""
    T, d = x.shape
    V = w.shape[1]
    loss = torch.empty(T, dtype=torch.float32, device=x.device)
    if T == 0:  # nothing to launch
        return loss
    labels = labels.to(torch.int32)
    # the C entry points launch on the thread's current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.float32:
            _call("fused_xent_f32", x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                  loss.data_ptr(), T, d, V, stream)
            fused_softmax_xent.launches += 1
            return loss
        xp, wp = tma_operands(x, w)
        splits, per = vocab_splits(T, V, _sms(x.device))
        part = torch.empty(3, splits, T, dtype=torch.float32, device=x.device)
        _call("fused_xent_bf16", xp.data_ptr(), wp.data_ptr(), labels.data_ptr(),
              part.data_ptr(), T, xp.shape[1], V, wp.shape[1], splits, per, stream)
        fused_softmax_xent.launches += 1
        _call("fused_xent_combine", part.data_ptr(), loss.data_ptr(), T, splits, stream)
        fused_softmax_xent.combine_launches += 1
    return loss


def _check(x, w, labels):
    """Device, dtype, contiguity and shape checks."""
    if len({x.device, w.device, labels.device}) != 1:
        raise ValueError("fused_softmax_xent operands must be on one device")
    if x.dtype not in _DTYPES:
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
    if is_dtensor(x) or is_dtensor(w):  # each rank's call checks its shards
        return _sharded(x, w, labels)
    _check(x, w, labels)
    (T, d), V = x.shape, w.shape[1]
    # x, w and the labels read once, the loss written once; 2 T d V for the product
    nbytes = (T * d + d * V) * x.element_size() + T * labels.element_size() + T * 4
    with custom_op("fused_xent", flops=2 * T * d * V, nbytes=nbytes):
        if is_fake(x):
            return torch.empty(T, dtype=torch.float32, device=x.device)
        if x.is_cuda:
            return _launch(x, w, labels)
        if x.device.type == "cpu":
            return softmax_xent_ref(x, w, labels)
    raise NotImplementedError(f"fused_softmax_xent has no kernel for {x.device}")


GOLD_ROWS = 1024  # tokens a step when `label_logits` gathers W's label columns


def label_logits(x, w, labels):
    """``(x @ w)[t, labels[t]]`` a token, rounded to x's dtype as the loss rounds it, as float32.

    Gathers W's label columns `GOLD_ROWS` tokens at a time, so it never
    holds more than (GOLD_ROWS, d) of them.
    """
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    wt = w.t()
    for t0 in range(0, x.shape[0], GOLD_ROWS):
        xs, cols = x[t0:t0 + GOLD_ROWS], wt[labels[t0:t0 + GOLD_ROWS].long()]
        out[t0:t0 + GOLD_ROWS] = torch.bmm(xs[:, None, :], cols[:, :, None])[:, 0, 0].float()
    return out


def _sharded(x, w, labels):
    """`fused_softmax_xent` on DTensors: the op on each rank's shards.

    The tokens keep x's shards (W's other shards, its FSDP ``embed``
    shards, are gathered); W keeps its vocab shards over the axes the
    tokens do not use.  Each rank runs the op on its vocab slice with each
    label moved into the slice (a label outside it reads column 0), which
    gives ``lse_r - logit_r``; adding back the logit it read
    (`label_logits`) leaves its partial logsumexp ``lse_r``.  Across the
    vocab's axes, two all-reduces combine them, as the kernel's own split
    and combine do: the max of the ``lse_r``, then the sum of
    ``exp(lse_r - max)`` beside the label's logit, which only the rank
    holding the label contributes.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    mesh = (x if is_dtensor(x) else w).device_mesh
    names = mesh.mesh_dim_names
    xd = sharded_dims(x) if is_dtensor(x) else {}
    wd = sharded_dims(w) if is_dtensor(w) else {}
    token_axes = [a for a in names if xd.get(a) == 0]
    vocab_axes = [a for a in names if wd.get(a) == 1 and a not in token_axes]
    t_place = tuple(Shard(0) if a in token_axes else Replicate() for a in names)
    w_place = tuple(Shard(1) if a in vocab_axes else Replicate() for a in names)
    V = w.shape[1]
    groups = [mesh.get_group(a) for a in vocab_axes]

    def run(xl, wl, ll):
        xl, wl, ll = xl.contiguous(), wl.contiguous(), ll.contiguous()
        if not vocab_axes:
            return fused_softmax_xent(xl, wl, ll)
        index, shards = shard_index(mesh, vocab_axes)
        lo = index * (V // shards)
        inside = (ll >= lo) & (ll < lo + wl.shape[1])
        local = torch.where(inside, ll - lo, torch.zeros_like(ll))
        read = label_logits(xl, wl, local)
        lse = fused_softmax_xent(xl, wl, local) + read
        top = lse.clone()
        for g in groups:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        parts = torch.stack([torch.exp(lse - top), torch.where(inside, read, 0.0)])
        for g in groups:
            dist.all_reduce(parts, op=dist.ReduceOp.SUM, group=g)
        return top + torch.log(parts[0]) - parts[1]

    return local_call(run, mesh, list(t_place), (t_place, w_place, t_place), x, w, labels)


# Launches of the CUDA kernels in this process (the product-and-fold kernel,
# and the bf16 path's combine); the plain CPU path counts neither.
fused_softmax_xent.launches = 0
fused_softmax_xent.combine_launches = 0
