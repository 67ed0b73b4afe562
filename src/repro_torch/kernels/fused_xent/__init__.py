"""Fused softmax cross-entropy: CUDA kernel, op, plain oracle."""
from repro_torch.kernels.fused_xent.ops import fused_softmax_xent
from repro_torch.kernels.fused_xent.ref import softmax_xent_ref

__all__ = ["fused_softmax_xent", "softmax_xent_ref"]
