"""MARL systems as `System` instances (port of `repro.systems`)."""
from repro_torch.systems.onpolicy import (
    PPOConfig,
    make_ippo,
    make_mappo,
    make_rec_ippo,
    make_rec_mappo,
)

__all__ = ["PPOConfig", "make_ippo", "make_mappo", "make_rec_ippo", "make_rec_mappo"]
