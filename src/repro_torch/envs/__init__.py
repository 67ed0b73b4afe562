"""Batched multi-agent envs, the wrapper stack and the registry (port of `repro.envs`).

`REGISTRY` holds the reference's seven envs under its names; `make_env`
raises `KeyError` for any other name, as the reference does.
"""
from repro_torch.envs.api import ArraySpec, DiscreteSpec, EnvSpec, StepType, TimeStep
from repro_torch.envs.lbf import LevelBasedForaging
from repro_torch.envs.matrix_game import MatrixGame
from repro_torch.envs.robot_warehouse import RobotWarehouse
from repro_torch.envs.smax_lite import SmaxLite
from repro_torch.envs.speaker_listener import SpeakerListener
from repro_torch.envs.spread import Spread
from repro_torch.envs.switch_game import SwitchGame
from repro_torch.envs.wrappers import (
    AgentIdObs,
    AutoReset,
    ConcatObsState,
    EpisodeStats,
    Wrapper,
    replace_reset_keys,
)


def _gridworld(cls):
    """Registry factory for the gridworld family: raw dynamics + the standard
    observation stack (one-hot agent ids, concat-of-observations global state)."""

    def factory(**kwargs):
        """Build the wrapped gridworld env with the registered stack."""
        return ConcatObsState(AgentIdObs(cls(**kwargs)))

    factory.__name__ = f"make_{cls.__name__}"
    factory.__doc__ = f"Wrapped {cls.__name__} (AgentIdObs + ConcatObsState)."
    return factory


REGISTRY = {
    "matrix_game": MatrixGame,
    "switch_game": SwitchGame,
    "spread": Spread,
    "speaker_listener": SpeakerListener,
    "smax_lite": SmaxLite,
    "robot_warehouse": _gridworld(RobotWarehouse),
    "lbf": _gridworld(LevelBasedForaging),
}


def make_env(name: str, **kwargs):
    """Build a registered environment by name (the launcher's entry)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown env {name!r}; registered: {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)


__all__ = [
    "AgentIdObs",
    "ArraySpec",
    "AutoReset",
    "ConcatObsState",
    "DiscreteSpec",
    "EnvSpec",
    "EpisodeStats",
    "LevelBasedForaging",
    "MatrixGame",
    "REGISTRY",
    "RobotWarehouse",
    "SmaxLite",
    "SpeakerListener",
    "Spread",
    "StepType",
    "SwitchGame",
    "TimeStep",
    "Wrapper",
    "make_env",
    "replace_reset_keys",
]
