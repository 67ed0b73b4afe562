"""Mamba1 selective scan: CUDA kernel, op, plain oracle."""
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref"]
