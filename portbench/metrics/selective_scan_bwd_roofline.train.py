"""The backward scan's bound over its device time (its three kernels together)."""
from portbench import readers


def read(trace, window):
    return readers.roofline(trace, window, "selective_scan_bwd", ("selective_scan_bwd",))
