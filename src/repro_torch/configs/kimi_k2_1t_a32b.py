"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 (paper-table config)
[arXiv:2501.kimi2].

``sharding="fsdp_tp"``, as in the reference: its published width spreads
over a mesh, whose fit `repro_torch.launch.dryrun` checks on 256 and 512
H100s.  On one card the published width runs cut in depth (README,
PERF.md §4); `sharding` is read only under a mesh.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,  # per-expert hidden dim (assignment table)
    vocab=163840,
    num_experts=384,
    top_k=8,
    sharding="fsdp_tp",
    source="arXiv:2501.kimi2",
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke",
    arch_type="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab=512,
    num_experts=4,
    top_k=2,
    capacity_factor=2.0,  # no-drop capacity: deterministic smoke/consistency tests
    moe_group_size=64,
    attn_chunk=16,
    xent_chunk=16,
    dtype="float32",
    source="arXiv:2501.kimi2",
)
