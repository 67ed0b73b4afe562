"""Share of the bf16 peak: 2 N a prefilled position, and the head a prompt, over the window."""
from portbench import readers


def read(trace, window):
    return readers.mfu(trace, window)
