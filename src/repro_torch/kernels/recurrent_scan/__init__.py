"""Gated linear recurrence: CUDA kernel, op with gradient, plain oracle."""
from repro_torch.kernels.recurrent_scan.ops import linear_recurrent_scan
from repro_torch.kernels.recurrent_scan.ref import linear_recurrence_ref, scan_ref

__all__ = ["linear_recurrent_scan", "linear_recurrence_ref", "scan_ref"]
