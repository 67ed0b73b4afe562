"""Reduce a `torch.profiler` trace of the window to what the metric readers take.

`Trace` holds the traced window's device activity: the busy time (the
union of every kernel, copy and fill interval on the card), each kernel
name's launches and device seconds, the host's CUDA launch calls, and the
breakdown the result line carries (the device operations that took most
time, the longest idle gaps by what the host was doing then).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")


@dataclasses.dataclass
class Trace:
    """What the profiler saw in the traced window (seconds)."""

    window_s: float
    busy_s: float
    kernels: dict  # name -> [launches, device seconds]
    host_launches: int
    device_ops: list
    idle_gaps: list
    reduce_s: float = 0.0

    def kernel(self, *parts: str, without: tuple = ()) -> tuple[int, float]:
        """Launches and device seconds of the kernels whose name holds every one of
        ``parts`` and none of ``without``."""
        n, s = 0, 0.0
        for name, (count, secs) in self.kernels.items():
            if all(p in name for p in parts) and not any(w in name for w in without):
                n, s = n + count, s + secs
        return n, s


def _short(name: str) -> str:
    """A kernel's name without its argument list, cut to 120 characters."""
    return name.replace("(anonymous namespace)::", "").split("(")[0][:120]


def _union_length(intervals: np.ndarray) -> tuple[float, np.ndarray]:
    """Total length of the union of ``intervals`` (n, 2) and the gaps between its pieces."""
    if not len(intervals):
        return 0.0, np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new piece starts where an interval begins after every earlier one has ended
    starts_new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    piece = np.cumsum(starts_new) - 1
    p_start = iv[starts_new, 0]
    p_end = np.zeros(piece[-1] + 1)
    np.maximum.at(p_end, piece, iv[:, 1])
    gaps = np.stack([p_end[:-1], p_start[1:]], axis=1)
    return float(np.sum(p_end - p_start)), gaps


def reduce(prof, window_s: float) -> Trace:
    """The `Trace` of a finished profiler ``prof`` over a window of ``window_s``."""
    from torch.autograd import DeviceType

    dev, cpu, names = [], [], []
    kernels: dict = {}
    launches = 0
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((start, end))
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += (end - start) / 1e6
        else:
            if e.name in LAUNCH_CALLS:
                launches += 1
            cpu.append((start, end))
            names.append(e.name)
    busy_us, gaps = _union_length(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
    top_ops: dict = {}
    for name, (_, secs) in kernels.items():
        top_ops[_short(name)] = top_ops.get(_short(name), 0.0) + secs
    device_ops = sorted(([n, s] for n, s in top_ops.items()), key=lambda x: -x[1])[:10]
    idle = []
    if len(gaps):
        cpu_iv = np.asarray(cpu, dtype=np.float64).reshape(-1, 2)
        for gi in np.argsort(gaps[:, 0] - gaps[:, 1])[:10]:
            g0, g1 = gaps[gi]
            mid = 0.5 * (g0 + g1)
            cover = np.nonzero((cpu_iv[:, 0] <= mid) & (cpu_iv[:, 1] >= mid))[0] if len(cpu_iv) \
                else np.zeros(0, dtype=int)
            label = (names[cover[np.argmin(cpu_iv[cover, 1] - cpu_iv[cover, 0])]]
                     if len(cover) else "host idle")
            idle.append([label, (g1 - g0) / 1e6])
    return Trace(window_s=window_s, busy_s=busy_us / 1e6, kernels=kernels,
                 host_launches=launches, device_ops=device_ops, idle_gaps=idle)


def traced(fn):
    """``fn()`` under the profiler, synchronised: ``(fn's result, Trace)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reduced = reduce(prof, window_s)
    reduced.reduce_s = time.perf_counter() - t0
    return out, reduced
