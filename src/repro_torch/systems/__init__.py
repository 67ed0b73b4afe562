"""MARL systems as `System` instances (port of `repro.systems`)."""
from repro_torch.systems.onpolicy import PPOConfig, make_rec_ippo

__all__ = ["PPOConfig", "make_rec_ippo"]
