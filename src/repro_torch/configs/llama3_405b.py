"""Llama-3.1-405B — GQA dense, 128k vocab [arXiv:2407.21783].

The reference's config also sets ``sharding="fsdp_tp"``: its published
width spreads over a mesh.  The port runs on one card and does not shard,
so its `ModelConfig` has no such field; the published width runs there
cut in depth (README, PERF.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    arch_type="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    source="arXiv:2407.21783",
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=1024,
    vocab=512,
    attn_chunk=16,
    xent_chunk=16,
    dtype="float32",
    source="arXiv:2407.21783",
)
