"""Share of the bf16 peak: 6 N a trained position over the window."""
from portbench import readers


def read(trace, window):
    return readers.mfu(trace, window)
