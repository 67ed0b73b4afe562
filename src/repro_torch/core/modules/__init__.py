"""Composable system modules (port of `repro.core.modules`)."""
from repro_torch.core.modules.communication import BroadcastedCommunication, dru
from repro_torch.core.modules.mixing import AdditiveMixing, MonotonicMixing
from repro_torch.core.modules.stabilisation import FingerPrintStabilisation

__all__ = [
    "AdditiveMixing", "BroadcastedCommunication", "FingerPrintStabilisation", "MonotonicMixing",
    "dru",
]
