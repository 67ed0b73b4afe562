"""Share of the traced window with no operation on the device."""
from portbench import readers


def read(trace, window):
    return readers.idle(trace, window)
