"""InternLM2-1.8B — GQA dense [arXiv:2403.17297]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    source="arXiv:2403.17297",
)

SMOKE = ModelConfig(
    name="internlm2-1.8b-smoke",
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
    source="arXiv:2403.17297",
)
