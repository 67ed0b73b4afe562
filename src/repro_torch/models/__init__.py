"""LM backbones for serving (port of `repro.models`, Mamba1 so far)."""
from repro_torch.models.config import ModelConfig

__all__ = ["ModelConfig"]
