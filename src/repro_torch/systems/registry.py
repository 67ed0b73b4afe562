"""The system registry: the ported algorithms behind one constructor.

Port of `repro.systems.registry`: a name -> `SystemEntry` table plus
``make_system(name, env, **overrides)`` and ``make_pair(system, env)``, so
the launcher and user code build every system the same way.  Each entry
declares the action regime its algorithm supports, and the env's spec is
checked against that, not its name; ``make_pair`` turns on an env's
continuous mode when a continuous-control system asks for it.

`REGISTRY` lists the systems ported so far, and the env registry the envs
ported so far.  ``compatibility(system, env)`` answers whether a (system,
env) cell runs and why not: the reference's reason for a spec mismatch,
or a plain "not ported" reason for a system or env the reference has and
the port does not.  It never builds half a system.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional

from repro_torch.envs import REGISTRY as ENV_REGISTRY
from repro_torch.envs.api import DiscreteSpec, EnvSpec
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
from repro_torch.systems.vdn import make_vdn

# The reference's registries, for "not ported" reasons (repro.systems.REGISTRY
# and repro.envs.REGISTRY; copied here so the port imports nothing of it).
REFERENCE_SYSTEMS = (
    "dial", "ippo", "mad4pg", "maddpg", "madqn", "madqn-fp", "mappo", "qmix",
    "rec_ippo", "rec_madqn", "rec_mappo", "rial", "vdn",
)
REFERENCE_ENVS = (
    "lbf", "matrix_game", "robot_warehouse", "smax_lite", "speaker_listener", "spread",
    "switch_game",
)


@dataclasses.dataclass(frozen=True)
class SystemEntry:
    """Registry row: how to build a system, and the action regime it supports."""

    factory: Callable[[Any, Any], Any]  # (env, cfg) -> System
    config_cls: type
    action_space: str = "discrete"  # "discrete" | "continuous"
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
    "rec_mappo": SystemEntry(
        make_rec_mappo, PPOConfig,
        description="recurrent MAPPO (memory cores + centralised recurrent critics)",
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


def _support_reason(system_name: str, action_space: str, spec: EnvSpec) -> Optional[str]:
    env_kind = env_action_space(spec)
    if env_kind != action_space:
        return (
            f"{system_name} supports {action_space} action spaces; "
            f"env has {env_kind} actions"
        )
    return None


def check_support(system_name: str, spec: EnvSpec) -> Optional[str]:
    """None when the system supports this env spec, else the reason not."""
    return _support_reason(system_name, REGISTRY[system_name].action_space, spec)


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


def _not_ported(system_name: str, env_name: str) -> Optional[str]:
    """The reason a name the reference knows cannot run here, or None."""
    for kind, name, ours, theirs in (
        ("system", system_name, REGISTRY, REFERENCE_SYSTEMS),
        ("env", env_name, ENV_REGISTRY, REFERENCE_ENVS),
    ):
        if name not in ours:
            if name not in theirs:
                raise KeyError(f"unknown {kind} {name!r}; registered: {sorted(ours)}")
            return f"{kind} {name!r} is not ported yet"
    return None


def compatibility(system_name: str, env_name: str, env_kwargs=None) -> Optional[str]:
    """None when the (system, env) cell runs in the port, else the reason not."""
    reason = _not_ported(system_name, env_name)
    if reason is not None:
        return reason
    try:
        kwargs = _env_kwargs_for(system_name, env_name, env_kwargs)
    except ValueError as e:
        return str(e)
    return check_support(system_name, ENV_REGISTRY[env_name](**kwargs).spec())


# ------------------------------------------------------------ constructors


def make_system(name: str, env, **overrides):
    """Build a registered system on ``env`` (the `repro_torch.envs.make_env` twin).

    ``overrides`` are fields of the entry's config dataclass (e.g.
    ``make_system("ippo", env, rollout_len=64)``).
    """
    if name not in REGISTRY:
        raise KeyError(f"unknown system {name!r}; registered: {sorted(REGISTRY)}")
    entry = REGISTRY[name]
    # pre-build: the factory itself would crash on a mismatched spec
    reason = check_support(name, env.spec())
    if reason is not None:
        raise ValueError(f"incompatible system/env: {reason}")
    system = entry.factory(env, entry.config_cls(**overrides))
    # post-build: the System's own declaration must agree with its entry
    reason = _support_reason(name, system.action_space, system.spec)
    if reason is not None:
        raise ValueError(f"incompatible system/env: {reason}")
    return system


def make_pair(system_name: str, env_name: str, *, env_kwargs: Optional[dict] = None,
              **overrides):
    """Build ``(env, system)`` by name; ``env_kwargs`` go to the env's constructor.

    A continuous-control system turns on the env's ``continuous=True``
    construction flag when the env has one (spec-checked afterwards).
    """
    if system_name not in REGISTRY:
        raise KeyError(f"unknown system {system_name!r}; registered: {sorted(REGISTRY)}")
    if env_name not in ENV_REGISTRY:
        raise KeyError(f"unknown env {env_name!r}; registered: {sorted(ENV_REGISTRY)}")
    kwargs = _env_kwargs_for(system_name, env_name, env_kwargs)
    env = ENV_REGISTRY[env_name](**kwargs)
    return env, make_system(system_name, env, **overrides)
