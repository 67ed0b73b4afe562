"""LLaVA-NeXT (Mistral-7B backbone) — anyres tiling VLM
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision tower (CLIP ViT-L/336 + 2-layer MLP projector) is a stub, as in
the reference: a prompt brings precomputed patch embeddings of shape
(B, vision_tokens, d_model). vision_tokens = 2880 = 5 tiles x 576 patches
(base image + 2x2 anyres grid).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    vision_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b-smoke",
    arch_type="vlm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab=512,
    vision_tokens=16,
    attn_chunk=16,
    xent_chunk=16,
    dtype="float32",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
