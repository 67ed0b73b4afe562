"""The system registry: the ported algorithms behind one constructor.

Port of `repro.systems.registry`: a name -> `SystemEntry` table of the
reference's thirteen systems plus ``make_system(name, env, *,
distributed_axis=None, **overrides)``
and ``make_pair(system, env)``, so the launcher and user code build every
system the same way.  Each entry declares the action regime its algorithm
supports and whether it needs homogeneous agents (DIAL's shared recurrent
weights); the env's spec is checked against that, not its name.
``make_pair`` turns on an env's continuous mode when a continuous-control
system asks for it.  ``compatibility(system, env)`` answers whether a
(system, env) cell runs and why not, in the reference's words, without
building anything.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional

from repro_torch.envs import REGISTRY as ENV_REGISTRY
from repro_torch.envs.api import DiscreteSpec, EnvSpec
from repro_torch.systems.dial import DialConfig, make_dial
from repro_torch.systems.maddpg import MaddpgConfig, make_mad4pg, make_maddpg
from repro_torch.systems.madqn import make_madqn
from repro_torch.systems.offpolicy import OffPolicyConfig
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


@dataclasses.dataclass(frozen=True)
class SystemEntry:
    """Registry row: how to build a system, and the action regime it supports."""

    factory: Callable[[Any, Any], Any]  # (env, cfg) -> System
    config_cls: type
    action_space: str = "discrete"  # "discrete" | "continuous"
    homogeneous_only: bool = False  # shared-weight recurrent systems
    description: str = ""


def _with(factory, **patch):
    return lambda env, cfg: factory(env, dataclasses.replace(cfg, **patch))


REGISTRY: Dict[str, SystemEntry] = {
    "madqn": SystemEntry(
        make_madqn, OffPolicyConfig,
        description="independent double-DQN learners",
    ),
    "madqn-fp": SystemEntry(
        _with(make_madqn, fingerprint=True), OffPolicyConfig,
        description="MADQN + policy-fingerprint replay stabilisation",
    ),
    "vdn": SystemEntry(
        make_vdn, OffPolicyConfig,
        description="value decomposition (additive mixing)",
    ),
    "qmix": SystemEntry(
        make_qmix, OffPolicyConfig,
        description="monotonic hypernetwork mixing",
    ),
    "maddpg": SystemEntry(
        make_maddpg, MaddpgConfig, action_space="continuous",
        description="centralised-critic DDPG (continuous control)",
    ),
    "mad4pg": SystemEntry(
        make_mad4pg, MaddpgConfig, action_space="continuous",
        description="MADDPG with a C51 distributional critic",
    ),
    "ippo": SystemEntry(
        make_ippo, PPOConfig,
        description="independent PPO (decentralised critics)",
    ),
    "mappo": SystemEntry(
        make_mappo, PPOConfig,
        description="PPO with centralised critics (CTDE)",
    ),
    "rec_ippo": SystemEntry(
        make_rec_ippo, PPOConfig,
        description="recurrent IPPO (memory cores, partial observability)",
    ),
    "rec_madqn": SystemEntry(
        make_rec_madqn, RecMadqnConfig,
        description="recurrent MADQN over R2D2 sequence replay (stored-carry windows, burn-in)",
    ),
    "rec_mappo": SystemEntry(
        make_rec_mappo, PPOConfig,
        description="recurrent MAPPO (memory cores + centralised recurrent critics)",
    ),
    "dial": SystemEntry(
        make_dial, DialConfig, homogeneous_only=True,
        description="differentiable inter-agent communication",
    ),
    "rial": SystemEntry(
        _with(make_dial, protocol="rial"), DialConfig, homogeneous_only=True,
        description="RIAL baseline (Q-learned discrete channel)",
    ),
}


# ----------------------------------------------------- spec-driven checks


def env_action_space(spec: EnvSpec) -> str:
    """The env's action regime, read off its spec (not its name)."""
    kinds = {
        "discrete" if isinstance(s, DiscreteSpec) else "continuous"
        for s in spec.actions.values()
    }
    return kinds.pop() if len(kinds) == 1 else "mixed"


def env_is_homogeneous(spec: EnvSpec) -> bool:
    """True when every agent shares one (observation shape, action spec) signature."""
    return len({(spec.observations[a].shape, repr(spec.actions[a])) for a in spec.agent_ids}) == 1


def _support_reason(system_name: str, action_space: str, homogeneous_only: bool,
                    spec: EnvSpec) -> Optional[str]:
    env_kind = env_action_space(spec)
    if env_kind != action_space:
        return (
            f"{system_name} supports {action_space} action spaces; "
            f"env has {env_kind} actions"
        )
    if homogeneous_only and not env_is_homogeneous(spec):
        return f"{system_name} requires homogeneous agents (shared weights)"
    return None


def check_support(system_name: str, spec: EnvSpec) -> Optional[str]:
    """None when the system supports this env spec, else the reason not."""
    entry = REGISTRY[system_name]
    return _support_reason(system_name, entry.action_space, entry.homogeneous_only, spec)


def _env_supports_continuous(env_name: str) -> bool:
    return "continuous" in inspect.signature(ENV_REGISTRY[env_name]).parameters


def _env_kwargs_for(system_name: str, env_name: str, env_kwargs=None) -> dict:
    kwargs = dict(env_kwargs or {})
    if kwargs.get("continuous") and not _env_supports_continuous(env_name):
        raise ValueError(
            f"env {env_name!r} has no continuous-action mode "
            "(no `continuous` construction flag)"
        )
    if (
        REGISTRY[system_name].action_space == "continuous"
        and "continuous" not in kwargs
        and _env_supports_continuous(env_name)
    ):
        kwargs["continuous"] = True
    return kwargs


def _known(system_name: str, env_name: str):
    """Raise `KeyError` for a system or env name neither registry holds."""
    if system_name not in REGISTRY:
        raise KeyError(f"unknown system {system_name!r}; registered: {sorted(REGISTRY)}")
    if env_name not in ENV_REGISTRY:
        raise KeyError(f"unknown env {env_name!r}; registered: {sorted(ENV_REGISTRY)}")


def compatibility(system_name: str, env_name: str, env_kwargs=None) -> Optional[str]:
    """None when the (system, env) cell runs, else the reason not."""
    _known(system_name, env_name)
    try:
        kwargs = _env_kwargs_for(system_name, env_name, env_kwargs)
    except ValueError as e:
        return str(e)
    return check_support(system_name, ENV_REGISTRY[env_name](**kwargs).spec())


# ------------------------------------------------------------ constructors


def make_system(name: str, env, *, distributed_axis: Optional[str] = None, **overrides):
    """Build a registered system on ``env`` (the `repro_torch.envs.make_env` twin).

    ``overrides`` are fields of the entry's config dataclass (e.g.
    ``make_system("ippo", env, rollout_len=64)``); ``distributed_axis``
    averages the gradients over that axis's ranks, for the sharded runner.
    """
    if name not in REGISTRY:
        raise KeyError(f"unknown system {name!r}; registered: {sorted(REGISTRY)}")
    entry = REGISTRY[name]
    # pre-build: the factory itself would crash on a mismatched spec
    reason = check_support(name, env.spec())
    if reason is not None:
        raise ValueError(f"incompatible system/env: {reason}")
    if distributed_axis is not None:
        overrides = dict(overrides, distributed_axis=distributed_axis)
    system = entry.factory(env, entry.config_cls(**overrides))
    # post-build: the System's own declaration must agree with its entry
    reason = _support_reason(name, system.action_space, entry.homogeneous_only, system.spec)
    if reason is not None:
        raise ValueError(f"incompatible system/env: {reason}")
    return system


def make_pair(system_name: str, env_name: str, *, distributed_axis: Optional[str] = None,
              env_kwargs: Optional[dict] = None, **overrides):
    """Build ``(env, system)`` by name; ``env_kwargs`` go to the env's constructor.

    A continuous-control system turns on the env's ``continuous=True``
    construction flag when the env has one (spec-checked afterwards).
    """
    _known(system_name, env_name)
    kwargs = _env_kwargs_for(system_name, env_name, env_kwargs)
    env = ENV_REGISTRY[env_name](**kwargs)
    return env, make_system(system_name, env, distributed_axis=distributed_axis, **overrides)
