"""Falcon-Mamba-7B — attention-free mamba1 SSM [arXiv:2410.05355]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    vocab=65024,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    mamba_version=1,
    source="arXiv:2410.05355",
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke",
    arch_type="ssm",
    num_layers=2,
    d_model=128,
    vocab=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=16,
    mamba_version=1,
    xent_chunk=16,
    dtype="float32",
    source="arXiv:2410.05355",
)
