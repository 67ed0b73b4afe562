"""CUDA launch calls a cycle, from the profiler's host events."""
from portbench import readers


def read(trace, window):
    return readers.host_launches(trace, window)
