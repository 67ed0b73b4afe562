"""MARL systems as `System` instances (port of `repro.systems`)."""
from repro_torch.systems.dial import DialConfig, make_dial
from repro_torch.systems.maddpg import MaddpgConfig, make_mad4pg, make_maddpg
from repro_torch.systems.madqn import make_madqn
from repro_torch.systems.offpolicy import OffPolicyConfig, make_offpolicy_system
from repro_torch.systems.onpolicy import (
    PPOConfig,
    make_ippo,
    make_mappo,
    make_rec_ippo,
    make_rec_mappo,
)
from repro_torch.systems.qmix import make_qmix
from repro_torch.systems.rec_madqn import RecMadqnConfig, make_rec_madqn
from repro_torch.systems.vdn import make_vdn

__all__ = [
    "DialConfig",
    "MaddpgConfig",
    "OffPolicyConfig",
    "PPOConfig",
    "RecMadqnConfig",
    "make_dial",
    "make_ippo",
    "make_mad4pg",
    "make_maddpg",
    "make_madqn",
    "make_mappo",
    "make_offpolicy_system",
    "make_qmix",
    "make_rec_ippo",
    "make_rec_madqn",
    "make_rec_mappo",
    "make_vdn",
]
