"""Minitron-8B — width/depth-pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    source="arXiv:2407.14679",
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab=512,
    attn_window=64,
    attn_chunk=16,
    xent_chunk=16,
    dtype="float32",
    source="arXiv:2407.14679",
)
