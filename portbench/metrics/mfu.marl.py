"""Share of the float32 peak (TF32 where the path runs it): actor and critic flops of each cycle."""
from portbench import readers


def read(trace, window):
    return readers.mfu(trace, window)
