"""Types, rollout buffer, `System` and its runners (port of `repro.core`)."""
from repro_torch.core.system import (
    System,
    init_system_state,
    make_anakin,
    make_distributed,
    run_environment_loop,
    seed_generators,
    train_anakin,
    train_distributed,
)
from repro_torch.core.types import Carry, EvalMetrics, SystemState, TrainState, Transition

__all__ = [
    "Carry",
    "EvalMetrics",
    "System",
    "SystemState",
    "TrainState",
    "Transition",
    "init_system_state",
    "make_anakin",
    "make_distributed",
    "run_environment_loop",
    "seed_generators",
    "train_anakin",
    "train_distributed",
]
