"""Llama-3.1-405B — GQA dense, 128k vocab [arXiv:2407.21783].

``sharding="fsdp_tp"``, as in the reference: its published width spreads
over a mesh, whose fit `repro_torch.launch.dryrun` checks on 256 and 512
H100s.  On one card the published width runs cut in depth (README,
PERF.md §4); `sharding` is read only under a mesh.
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
    sharding="fsdp_tp",
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
