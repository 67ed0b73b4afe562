"""The fused loss's bound over its device time (the product-and-fold and the combine)."""
from portbench import readers


def read(trace, window):
    return readers.roofline(trace, window, "fused_xent", ("xent",))
