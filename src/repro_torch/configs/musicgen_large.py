"""MusicGen-Large — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec conv codec is a stub, as in the reference: a prompt brings the
token ids of the 4 codebooks directly.  The delay-pattern interleave is
`repro_torch.models.audio`.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    num_codebooks=4,
    source="arXiv:2306.05284",
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    arch_type="audio",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab=64,
    num_codebooks=4,
    attn_chunk=16,
    xent_chunk=16,
    dtype="float32",
    source="arXiv:2306.05284",
)
