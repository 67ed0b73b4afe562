"""Profiler hooks: trace capture, run-time compile counting, op-cost summaries.

Port of `repro.obs.profile`.  Three ways to see why a run is slow, all
attached to the run record:

  * `profile_trace(dir)`: a context manager around `torch.profiler`
    (CPU and, where there is one, CUDA activity) that writes a Chrome
    trace, ``trace.json``, into the directory.  Like the reference it is
    an observer: when the profiler cannot start, the body runs anyway and
    the returned dict says ``skipped`` and why.
  * `RetraceCounter`: eager PyTorch traces and compiles nothing the way a
    jit does, so it counts what the port does compile at run time, the
    first-use builds (nvcc) and loads of the ``kernels/csrc`` sources,
    and the seconds the builds took.  The port captures no CUDA graph
    yet; once it does, the captures belong here too.
  * `roofline_summary(fn, *args)`: the `repro_torch.roofline.op_cost`
    count of one call (flops, bytes, collective bytes, and each hand
    kernel's own share), under the reference's keys.
"""
from __future__ import annotations

import contextlib
import pathlib
from typing import Any, Dict

import torch


class RetraceCounter:
    """Count the kernel builds and loads (and the build seconds) inside a ``with`` region.

        with RetraceCounter() as rc:
            out = program(seed)
        rc.kernel_builds, rc.kernel_loads, rc.compile_seconds

    Re-enterable: each ``with`` takes fresh snapshots.  ``summary()`` is
    the dict the run record stores under ``"retrace"``.
    """

    def __enter__(self) -> "RetraceCounter":
        from repro_torch.kernels import BUILD_EVENTS

        self._events = BUILD_EVENTS
        self._start = dict(BUILD_EVENTS)
        return self

    def __exit__(self, *exc) -> None:
        delta = {k: self._events[k] - self._start.get(k, 0)
                 for k in ("builds", "loads", "build_seconds")}
        self.kernel_builds = int(delta["builds"])
        self.kernel_loads = int(delta["loads"])
        self.compile_seconds = float(delta["build_seconds"])

    def summary(self) -> Dict[str, float]:
        """The run-record ``retrace`` block (call after the region exits).

        Under the reference's keys: ``jaxpr_traces`` is 0 (eager PyTorch
        traces nothing), ``backend_compiles`` counts the kernel builds;
        ``kernel_loads`` is the port's own.
        """
        return {
            "jaxpr_traces": 0,
            "backend_compiles": self.kernel_builds,
            "kernel_loads": self.kernel_loads,
            "compile_seconds": self.compile_seconds,
        }


@contextlib.contextmanager
def profile_trace(out_dir):
    """Capture a `torch.profiler` trace into ``out_dir/trace.json`` around the body.

    Yields a dict describing the capture (``trace_dir``, and
    ``trace_file`` once written, or ``skipped`` with the reason the
    profiler could not start); the body runs either way.
    """
    from torch.profiler import ProfilerActivity, profile

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    info: Dict[str, Any] = {"trace_dir": str(out)}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except RuntimeError as e:  # another profiler is active, or CUPTI refused
        prof = None
        info["skipped"] = f"{type(e).__name__}: {e}"
    try:
        yield info
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            path = out / "trace.json"
            prof.export_chrome_trace(str(path))
            info["trace_file"] = str(path)


def roofline_summary(fn, *args, **kwargs) -> Dict[str, Any]:
    """The op-cost block of one call ``fn(*args, **kwargs)``.

    Every op the call dispatches is counted once per time it runs, so a
    loop's body counts once per trip, as the reference's trip-count-aware
    HLO walk counts it.  The keys are the reference's (``hlo_flops``,
    ``hlo_bytes``, ``collective_bytes``, ``collectives``), plus
    ``custom_ops``: each hand kernel's calls, flops and bytes.
    """
    from repro_torch.roofline.op_cost import module_cost

    cost = module_cost(fn, *args, **kwargs)
    return {
        "hlo_flops": float(cost.flops),
        "hlo_bytes": float(cost.bytes),
        "collective_bytes": float(cost.collective_bytes),
        "collectives": {k: float(v) for k, v in cost.collectives.items()},
        "custom_ops": cost.custom_ops,
    }
