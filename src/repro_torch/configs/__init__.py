"""Model configurations the port runs (counterpart of `repro.configs`)."""
from repro_torch.configs.registry import (
    ARCH_IDS,
    KNOWN_ARCH_IDS,
    get_config,
    get_smoke_config,
)

__all__ = ["ARCH_IDS", "KNOWN_ARCH_IDS", "get_config", "get_smoke_config"]
