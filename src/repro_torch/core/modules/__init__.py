"""Composable system modules (port of `repro.core.modules`; DIAL's communication is not ported yet)."""
from repro_torch.core.modules.mixing import AdditiveMixing, MonotonicMixing
from repro_torch.core.modules.stabilisation import FingerPrintStabilisation

__all__ = ["AdditiveMixing", "FingerPrintStabilisation", "MonotonicMixing"]
