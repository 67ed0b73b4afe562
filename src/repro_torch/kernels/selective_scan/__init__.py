"""Mamba1 selective scan: CUDA kernels (forward and backward), op, plain oracle."""
from repro_torch.kernels.selective_scan.ops import selective_scan, selective_scan_bwd
from repro_torch.kernels.selective_scan.ref import (
    selective_scan_bwd_blocked,
    selective_scan_ref,
    selective_scan_ref_vjp,
)

__all__ = ["selective_scan", "selective_scan_bwd", "selective_scan_bwd_blocked",
           "selective_scan_ref", "selective_scan_ref_vjp"]
