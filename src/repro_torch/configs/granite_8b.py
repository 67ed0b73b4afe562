"""Granite-8B-Code — llama-arch dense for code [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    source="arXiv:2405.04324",
)

SMOKE = ModelConfig(
    name="granite-8b-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab=512,
    attn_chunk=16,
    xent_chunk=16,
    dtype="float32",
    source="arXiv:2405.04324",
)
