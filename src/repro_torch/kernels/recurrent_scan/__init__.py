"""Gated linear recurrence: CUDA kernel, op with gradient, plain oracle."""
from repro_torch.kernels.recurrent_scan.ops import linear_recurrent_scan
from repro_torch.kernels.recurrent_scan.ref import (
    chunked_scan_ref,
    linear_recurrence_ref,
    scan_ref,
)

__all__ = [
    "chunked_scan_ref", "linear_recurrent_scan", "linear_recurrence_ref", "scan_ref",
]
