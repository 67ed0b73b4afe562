"""LM backbones (port of `repro.models`): dense, MoE and Mamba1."""
from repro_torch.models.config import ModelConfig

__all__ = ["ModelConfig"]
