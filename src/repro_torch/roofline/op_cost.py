"""Cost counting over dispatched aten ops: the port's `repro.roofline.hlo_cost`.

The reference parses the optimized HLO of a compiled program and scales
each while-loop body by its trip count.  Eager PyTorch has no program to
parse, but every op it runs passes through the dispatcher, and a loop in
Python dispatches its body once per trip: counting what is dispatched
counts the trips for free.  `OpCost` is a `TorchDispatchMode` that counts,
for every aten op run inside it:

  flops       — the matmul family (``mm``, ``addmm``, ``bmm``,
                ``baddbmm``, ``mv``, ``addmv``, ``dot``):
                ``2 * prod(result dims) * K`` with K the contracted length,
                as `hlo_cost._dot_flops` counts a dot (a bias add is not
                counted, as it is not in a fused HLO dot);
  bytes       — operands + result of each op (`hlo_cost._instr_bytes`);
                ops that only make views or metadata move nothing and are
                skipped, as the reference skips bitcasts and tuples;
  collectives — result bytes per kind of the ``torch.distributed`` calls
                (c10d ops: all-reduce, all-gather, reduce-scatter,
                all-to-all, broadcast; and the functional collectives
                DTensor issues, ``_c10d_functional``).

On DTensors a counter sees each op twice: first at the DTensor level, at
global shapes, then as the local op a rank runs on its shards, followed
by the local collectives of any redistribution.  Only the local ops and
collectives are counted (an op with a DTensor operand is skipped), so a
count is one device's work: a matmul whose weight is sharded four ways
costs a quarter, a replicated one its whole.

The hand-written kernels are called through ctypes, not the dispatcher,
so a counter would see nothing of them (and on the CPU it would see their
plain versions' elementwise loops instead).  Each kernel wrapper therefore
reports its own cost through `custom_op`, which adds it and pauses the
dispatch count for the ops inside, so a run costs the same on the CPU and
on the card.  Counters nest: every active one sees every op.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "broadcast")
_C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}

# DTensor's local collectives (`torch.distributed._functional_collectives`)
_FUNCTIONAL_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}

_ACTIVE: list = []  # the counters inside whose ``with`` the program runs
_PAUSED = [0]  # > 0 while a custom op's plain ops run


@dataclasses.dataclass
class Cost:
    """Counted work: flops, bytes, collective bytes by kind, and each custom op's share."""

    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    custom_ops: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        """The collective bytes of every kind together."""
        return sum(self.collectives.values())


def _any_dtensor(values) -> bool:
    if not any(type(x).__name__ == "DTensor" for x in values):
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(x, DTensor) for x in values)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _matmul_flops(name: str, args, out) -> float:
    """``2 * prod(result) * K`` for the matmul family, else 0."""
    if name in ("mm", "bmm", "mv", "dot"):
        lhs = args[0]
    elif name in ("addmm", "baddbmm", "addmv"):
        lhs = args[1]
    else:
        return 0.0
    return 2.0 * math.prod(out.shape) * lhs.shape[-1]


def _is_view(func) -> bool:
    """Ops whose outputs alias an input (views, reshapes, ``detach``): no bytes move."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


_METADATA_OPS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                 "lift_fresh", "set_", "resize_", "_local_scalar_dense"}


class OpCost(TorchDispatchMode):
    """Count flops, bytes and collective bytes of the aten ops run inside ``with``.

        with OpCost() as counter:
            loss = step(params, batch)
        counter.cost.flops, counter.cost.bytes, counter.cost.collectives
    """

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _PAUSED[0]:
            self._count(func, args, kwargs or {}, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        operands = tree_flatten((args, kwargs))[0]
        if _any_dtensor(operands):
            return  # the DTensor-level call; its local ops follow
        if ns == "_c10d_functional":
            kind = _FUNCTIONAL_KINDS.get(name)
            if kind is not None:
                moved = sum(_nbytes(x) for x in tree_flatten(out)[0])
                self.cost.collectives[kind] += moved
                self.cost.bytes += 2 * moved
            return
        if ns == "c10d":
            kind = _C10D_KINDS.get(name)
            if kind is not None:
                moved = sum(_nbytes(x) for x in tree_flatten(args[0])[0])
                self.cost.collectives[kind] += moved
                self.cost.bytes += 2 * moved
            return
        if ns != "aten" or name in _METADATA_OPS or _is_view(func):
            return
        self.cost.flops += _matmul_flops(name, args, out)
        self.cost.bytes += sum(_nbytes(x) for x in operands)
        self.cost.bytes += sum(_nbytes(x) for x in tree_flatten(out)[0])


@contextlib.contextmanager
def custom_op(name: str, flops: float, nbytes: float):
    """Add a hand kernel's own cost to every active counter; count nothing inside.

    A kernel wrapper runs its launch (or, on the CPU, its plain version)
    inside this.  With no counter active it adds only the context
    manager's own cost, about a microsecond.
    """
    for counter in _ACTIVE:
        entry = counter.cost.custom_ops.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        entry["calls"] += 1
        entry["flops"] += flops
        entry["bytes"] += nbytes
        counter.cost.flops += flops
        counter.cost.bytes += nbytes
    paused = bool(_ACTIVE)
    _PAUSED[0] += paused
    try:
        yield
    finally:
        _PAUSED[0] -= paused


def module_cost(fn, *args, **kwargs) -> Cost:
    """The counted cost of one call ``fn(*args, **kwargs)``."""
    with OpCost() as counter:
        fn(*args, **kwargs)
    return counter.cost
