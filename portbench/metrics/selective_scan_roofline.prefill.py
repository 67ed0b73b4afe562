"""The forward scan's bound over its device time."""
from portbench import readers


def read(trace, window):
    return readers.roofline(trace, window, "selective_scan", ("selective_scan",), without=("_bwd",))
