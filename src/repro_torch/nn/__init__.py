"""Functional layers and memory cores on plain tensors (port of `repro.nn`)."""
from repro_torch.nn import initializers
from repro_torch.nn.layers import MLP, Dense, Embed, GRUCell, LayerNorm, RMSNorm, Sequential
from repro_torch.nn.recurrent import (
    LinearScannedRNN,
    ScannedRNN,
    burn_in_carry,
    make_core,
    reset_carry,
    window_start_carry,
)

__all__ = [
    "Dense",
    "Embed",
    "RMSNorm",
    "LayerNorm",
    "GRUCell",
    "LinearScannedRNN",
    "MLP",
    "ScannedRNN",
    "Sequential",
    "burn_in_carry",
    "initializers",
    "make_core",
    "reset_carry",
    "window_start_carry",
]
