"""Functional layers and memory cores on plain tensors (port of `repro.nn`)."""
from repro_torch.nn import initializers
from repro_torch.nn.layers import MLP, Dense, GRUCell
from repro_torch.nn.recurrent import (
    LinearScannedRNN,
    ScannedRNN,
    make_core,
    reset_carry,
    window_start_carry,
)

__all__ = [
    "Dense",
    "GRUCell",
    "LinearScannedRNN",
    "MLP",
    "ScannedRNN",
    "initializers",
    "make_core",
    "reset_carry",
    "window_start_carry",
]
