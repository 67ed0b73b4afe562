"""MAPPO: PPO with centralised critics on the global state (CTDE)."""
from repro_torch.systems.onpolicy import PPOConfig, make_mappo

__all__ = ["make_mappo", "PPOConfig"]
