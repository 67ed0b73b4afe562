"""Flash attention: CUDA forward kernel, op with its backward, plain oracle."""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_vjp

__all__ = ["attention_ref", "attention_ref_vjp", "flash_attention"]
