"""Collectives across ranks, and the spawned world the sharded runner runs in.

`pmean` is the port's counterpart of ``jax.lax.pmean``: a system built
with ``distributed_axis="data"`` averages its gradients with it before
every optimizer step, over the process group that the axis name is bound
to (`bind_axis`; the runner binds ``"data"`` to its world).  The
gradients travel as one flat buffer a step, summed and then divided by
the world size (gloo has no average).  An axis that no runner bound
raises: a system never silently trains unsynchronised.

`run_world` spawns one process a rank (the ``spawn`` start method; the
entry function is this module's `_worker`), joins them through a
``file://`` store in a fresh temporary directory, runs ``fn(rank,
world_size, device, *args)`` on every rank with ``"data"`` bound to the
world, and returns every rank's result.  The backend and each rank's
device are the caller's choice: gloo on the CPU, NCCL with one CUDA
device a rank, or gloo with CUDA tensors where several ranks share one
card (NCCL refuses that).
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map

_AXES: dict = {}  # axis name -> process group, while a runner has it bound


@contextlib.contextmanager
def bind_axis(name: str):
    """Map the axis ``name`` to the world's process group within the block."""
    if name in _AXES:
        raise ValueError(f"axis {name!r} is already bound")
    _AXES[name] = dist.group.WORLD
    try:
        yield
    finally:
        del _AXES[name]


def _group(axis: str):
    try:
        return _AXES[axis]
    except KeyError:
        raise RuntimeError(
            f"no process group is bound to axis {axis!r}: run the system under a runner "
            "that binds it (repro_torch.core.system.train_distributed)"
        ) from None


def _flat(tree):
    leaves = tree_leaves(tree)
    if len({x.dtype for x in leaves}) > 1:
        raise ValueError(f"one dtype a buffer; got {sorted({str(x.dtype) for x in leaves})}")
    return leaves, torch.cat([x.reshape(-1) for x in leaves])


def _unflat(tree, leaves, flat):
    """``tree`` with each leaf replaced by its part of ``flat`` (leaves in `tree_leaves` order)."""
    parts = torch.split(flat, [x.numel() for x in leaves])
    by_id = {id(x): p.view_as(x) for x, p in zip(leaves, parts)}
    return tree_map(lambda x: by_id[id(x)], tree)


def pmean(tree, axis: str):
    """The mean of ``tree`` (a tree of tensors of one dtype) over the ranks bound to ``axis``."""
    group = _group(axis)
    leaves, flat = _flat(tree)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return _unflat(tree, leaves, flat / dist.get_world_size(group))


def broadcast(tree):
    """Rank 0's ``tree`` on every rank of the ``"data"`` axis (one flat buffer)."""
    leaves, flat = _flat(tree)
    dist.broadcast(flat, src=0, group=_group("data"))
    return _unflat(tree, leaves, flat)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every ``"data"`` rank's ``x``, stacked along a new leading ``(world_size,)`` axis."""
    group = _group("data")
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


# ----------------------------------------------------------- spawned world


def _worker(fn, rank, world_size, backend, device, init_method, out_dir, timeout_s, args):
    """One rank: join the world, run ``fn`` with ``"data"`` bound, save what it returns."""
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            # every rank has joined; NCCL sets up its communicator here, not
            # inside the first update's all-reduce
            dist.barrier(device_ids=[device.index] if backend == "nccl" else None)
            with bind_axis("data"):
                out = fn(rank, world_size, device, *args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            dist.destroy_process_group()
        path = os.path.join(out_dir, f"result_{rank}.pt")
        torch.save(out, path + ".part")
        os.replace(path + ".part", path)
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def rank_devices(device, world_size: int) -> list:
    """Each rank's device: ``"cpu"`` for all, ``"cuda"`` one card a rank, or a list of devices.

    ``"cuda"`` raises when the machine has fewer cards than ranks.
    """
    if isinstance(device, (list, tuple)):
        if len(device) != world_size:
            raise ValueError(f"{len(device)} devices for {world_size} ranks")
        return [str(d) for d in device]
    device = torch.device(device)
    if device.type == "cpu":
        return ["cpu"] * world_size
    if device.index is not None:
        raise ValueError(f"{device}: give one CUDA device a rank, or a list of devices")
    if torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} CUDA devices, one a rank; "
                           f"this machine has {torch.cuda.device_count()}")
    return [f"cuda:{r}" for r in range(world_size)]


def run_world(fn, world_size: int, backend: str, devices, args=(), timeout_s: float = 900.0):
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` spawned ranks.

    ``fn`` and ``args`` must pickle (``fn`` by its import path).  Returns
    the list of every rank's result, each on the device it was made on.
    A rank that fails, or a world that outlasts ``timeout_s``, stops every
    rank and raises with the failing rank's traceback.
    """
    devices = rank_devices(devices, world_size)
    if backend == "nccl" and (len(set(devices)) < world_size
                              or any(not d.startswith("cuda") for d in devices)):
        raise ValueError(f"nccl needs one CUDA device a rank; got {devices}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, args=(fn, rank, world_size, backend, devices[rank],
                                                   init_method, tmp, timeout_s, tuple(args)))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout_s
            alive = list(procs)
            while alive:
                wait([p.sentinel for p in alive], timeout=max(deadline - time.monotonic(), 0))
                alive = [p for p in procs if p.is_alive()]
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} failed:\n" + _error(tmp, failed[0]))
                if alive and time.monotonic() >= deadline:
                    raise TimeoutError(f"the world of {world_size} ranks outlasted {timeout_s} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                for r in range(world_size)]


def _error(out_dir, rank) -> str:
    try:
        with open(os.path.join(out_dir, f"error_{rank}.txt")) as f:
            return f.read()
    except FileNotFoundError:
        return "(no traceback: the process ended without one)"
