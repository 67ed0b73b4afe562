"""IPPO: independent PPO (decentralised critics)."""
from repro_torch.systems.onpolicy import PPOConfig, make_ippo

__all__ = ["make_ippo", "PPOConfig"]
