"""Batched multi-agent envs and the wrapper stack (port of `repro.envs`)."""
from repro_torch.envs.api import ArraySpec, DiscreteSpec, EnvSpec, StepType, TimeStep
from repro_torch.envs.matrix_game import MatrixGame
from repro_torch.envs.wrappers import AutoReset, EpisodeStats, replace_reset_keys

__all__ = [
    "ArraySpec",
    "AutoReset",
    "DiscreteSpec",
    "EnvSpec",
    "EpisodeStats",
    "MatrixGame",
    "StepType",
    "TimeStep",
    "replace_reset_keys",
]
