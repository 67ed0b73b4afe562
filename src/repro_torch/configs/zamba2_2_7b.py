"""Zamba2-2.7B — mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    mamba_version=2,
    ssm_chunk=128,
    attn_every=6,   # shared attention block after every 6 mamba2 layers
    shared_attn=True,
    attn_window=4096,  # shared blocks use a window so long_500k stays sub-quadratic
    source="arXiv:2411.15242",
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    arch_type="hybrid",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=32,
    mamba_version=2,
    ssm_chunk=16,
    attn_every=2,
    shared_attn=True,
    attn_window=32,
    attn_chunk=16,
    xent_chunk=16,
    dtype="float32",
    source="arXiv:2411.15242",
)
