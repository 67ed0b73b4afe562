"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    num_experts=64,
    top_k=8,
    source="arXiv:2409.02060",
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke",
    arch_type="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab=512,
    num_experts=4,
    top_k=2,
    capacity_factor=2.0,  # no-drop capacity: deterministic smoke/consistency tests
    moe_group_size=64,
    attn_chunk=16,
    xent_chunk=16,
    dtype="float32",
    source="arXiv:2409.02060",
)
