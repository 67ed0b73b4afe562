"""In-flight metric streaming out of the training runners (port of `repro.obs.stream`).

A long anakin run prints nothing until it returns.  `MetricTap` is the
host end of the telemetry tap: the runners call it every ``log_every``
iterations (``make_anakin(..., log_every=, log_callback=)``, and likewise
the sharded and async runners), and it turns the iteration's metrics into
a logger row with live steps a second and the trainer's update count.

The runners keep the tap a pure observer, as the reference's
``jax.debug.callback`` is: the tap gets host copies and returns nothing,
so a run with the tap on is bitwise the run with it off.  An iteration
that does not log touches nothing of the tap's.  On one that logs, the
iteration's tensors leave the device in one copy (`HostCopy`), queued
behind the work already queued and delivered once it has landed, so the
host never waits on the device for it; a run delivers the last ones
before it returns.

SPS is wall time from `reset_clock`, so it is live telemetry, not a
benchmark: the first row absorbs the first-use costs (kernel builds,
cuBLAS handles).
"""
from __future__ import annotations

import time
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.obs.sinks import Logger
from repro_torch.tree import tree_leaves, tree_map


def _flat(tensors) -> torch.Tensor:
    return torch.cat([x.detach().reshape(-1).to(torch.float64) for x in tensors])


def _unflat(tree, tensors, flat: np.ndarray):
    """``tree`` with each tensor replaced by its part of ``flat``, in its shape and dtype."""
    parts, start = {}, 0
    for x in tensors:
        n = x.numel()
        dtype = np.float32 if x.dtype == torch.bfloat16 else torch.empty(0, dtype=x.dtype).numpy().dtype
        parts[id(x)] = flat[start:start + n].reshape(tuple(x.shape)).astype(dtype)
        start += n
    return tree_map(lambda x: parts[id(x)] if isinstance(x, torch.Tensor) else x, tree)


def host_values(tree):
    """``tree`` with every tensor leaf replaced by a numpy copy, all in one transfer.

    The tensors are flattened into one float64 buffer on their device,
    copied to the host at once (one wait on the device), and split back
    into their shapes and dtypes: float32, int32 and bool values cross
    exactly (bfloat16 comes back as float32).  Leaves that are not tensors
    stay as they are.
    """
    tensors = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    if not tensors:
        return tree
    return _unflat(tree, tensors, _flat(tensors).cpu().numpy())


class HostCopy:
    """`host_values` without the wait: the copy is queued on the device's stream.

    On a GPU the flattened values go into pinned host memory behind the
    work already queued, and an event marks their arrival: `ready` asks
    the event (no wait) or, with ``wait``, waits for it; `result` splits
    them as `host_values` does.  On the CPU the copy is there at once.
    """

    def __init__(self, tree):
        self._tree = tree
        self._tensors = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
        self._event = None
        if not self._tensors:
            return
        flat = _flat(self._tensors)
        if flat.is_cuda:
            self._host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self._host.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(flat.device))
        else:
            self._host = flat

    def ready(self, wait: bool = False) -> bool:
        """Whether the values have reached the host (with ``wait``, wait until they have)."""
        if self._event is None:
            return True
        if wait:
            self._event.synchronize()
            return True
        return self._event.query()

    def result(self):
        """The tree with host values (call once `ready`)."""
        if not self._tensors:
            return self._tree
        return _unflat(self._tree, self._tensors, self._host.numpy())


class MetricTap:
    """Host-side receiver of the runners' metric emissions.

    Args:
      logger: any `repro_torch.obs.sinks.Logger` (wrap it in
        `SeedAggregator` for seed-lane runs, so lane axes collapse to
        mean / min / max).
      log_every: the emission period the runner was given, recorded so
        rows can report their iteration.
      steps_per_iteration: env steps one iteration advances (num_envs x
        num_seeds, or an async tick's unroll x envs x actors), for the
        live SPS column.
    """

    def __init__(self, logger: Logger, log_every: int, steps_per_iteration: int):
        if log_every <= 0:
            raise ValueError(f"log_every must be positive, got {log_every}")
        self.logger = logger
        self.log_every = log_every
        self.steps_per_iteration = steps_per_iteration
        self.emits = 0
        self._t0: Optional[float] = None
        self.reset_clock()

    def reset_clock(self) -> None:
        """Restart the SPS wall clock (call right before starting the run)."""
        self._t0 = time.perf_counter()

    def __call__(self, iteration, updates, metrics: Mapping[str, Any]) -> None:
        """One emission: ``iteration`` is 0-based, ``updates`` the trainer's update count.

        ``updates`` may be a ``(num_seeds,)`` lane array, forwarded as it
        is so the logger's aggregation decides; ``metrics`` is the
        iteration's metric dict.
        """
        it = int(np.asarray(iteration))
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        row = {
            "iteration": it + 1,
            "updates": updates,
            "sps": (it + 1) * self.steps_per_iteration / elapsed,
        }
        row.update(metrics)
        self.emits += 1
        self.logger.write(row, step=it + 1)
