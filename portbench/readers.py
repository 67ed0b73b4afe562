"""Shared arithmetic of the per-layer metric readers (each `metrics/<name>.py` calls one).

A reader takes the traced window's `trace.Trace` and the driver's account of
the window's work, and returns a number, or None where it finds nothing to
read: then the metric is left out of the line.  Shares are in percent.
"""
from __future__ import annotations

from portbench import counts

BOUNDS = {"selective_scan": counts.selective_scan_bound_s,
          "selective_scan_bwd": counts.selective_scan_bwd_bound_s,
          "fused_xent": counts.fused_xent_bound_s}


def idle(trace, window) -> float | None:
    """The share of the traced window in which no operation ran on the device."""
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(trace, window) -> float | None:
    """The window's useful model flops (the benchmark's count) over its time at the peak."""
    if not window.get("model_flops"):
        return None
    return 100.0 * window["model_flops"] / window["seconds"] / window["peak_flops"]


def roofline(trace, window, kernel: str, parts: tuple, without: tuple = ()) -> float | None:
    """The kernel's least time at each call's shape (`counts`) over its device time."""
    calls = window.get("calls", {}).get(kernel)
    launches, seconds = trace.kernel(*parts, without=without)
    if not calls or not launches or seconds <= 0:
        return None
    return 100.0 * sum(BOUNDS[kernel](*shape) for shape in calls) / seconds


def host_launches(trace, window) -> float | None:
    """CUDA launch calls the host made a cycle."""
    if not trace.host_launches or not window.get("cycles"):
        return None
    return trace.host_launches / window["cycles"]
