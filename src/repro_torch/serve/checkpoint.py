"""Self-describing MARL policy checkpoints: the train -> serve hand-off (port of `repro.serve.checkpoint`).

A policy checkpoint is a directory holding the trained `TrainState`
(saved through `repro_torch.checkpoint`, the reference's .npz format) next
to a ``policy.json`` recording the registry system name, env name, config
overrides and provenance, so it restores by name alone:

    save_policy(dir, "rec_ippo", "matrix_game", train_state)
    env, system, train = load_policy(dir)        # rebuilt from the registry

A seed-lane run (``train_anakin(..., num_seeds=N)``) gives train states
whose tensors lead with ``(N,)``; `save_policy` writes each lane under
``seed_<s>/`` so it restores as an ordinary single-seed policy
(``load_policy(dir, seed=s)``).  The sharded runner returns bare params;
they save with ``"tree": "params"`` and restore inside a zero-step
`TrainState` (enough to serve and evaluate, not to resume training).

The format and the fields are the reference's, so a directory the JAX
package wrote restores here; ``provenance`` is the port's
(`repro_torch.obs.provenance`) in a directory the port writes.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.system import init_system_state
from repro_torch.core.types import SystemState, TrainState
from repro_torch.tree import tree_leaves, tree_map

POLICY_META = "policy.json"
_FORMAT = "marl-policy-v1"


def save_policy(directory: str, system_name: str, env_name: str, train: Any, *,
                config_overrides: Optional[dict] = None, env_kwargs: Optional[dict] = None,
                num_seeds: Optional[int] = None, step: int = 0) -> str:
    """Write a self-describing policy checkpoint directory; return the metadata path.

    ``train`` is a full `TrainState` or bare params (the sharded runner's
    output).  With ``num_seeds`` every tensor of ``train`` leads with a
    ``(num_seeds,)`` lane axis, and lane ``s`` is saved under
    ``seed_<s>/`` as an independent policy.
    """
    from repro_torch.obs import provenance

    os.makedirs(directory, exist_ok=True)
    if num_seeds:
        for s in range(num_seeds):
            lane = tree_map(lambda x, s=s: x[s] if isinstance(x, torch.Tensor) else x, train)
            save_checkpoint(os.path.join(directory, f"seed_{s}"), step, lane)
    else:
        save_checkpoint(directory, step, train)
    tensors = [x for x in tree_leaves(train) if isinstance(x, torch.Tensor)]
    meta = {
        "format": _FORMAT,
        "system": system_name,
        "env": env_name,
        "config_overrides": _jsonable(config_overrides or {}),
        "env_kwargs": _jsonable(env_kwargs or {}),
        "num_seeds": num_seeds,
        "step": step,
        "tree": "train_state" if isinstance(train, TrainState) else "params",
        "provenance": provenance(tensors[0].device if tensors else "cpu"),
    }
    path = os.path.join(directory, POLICY_META)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


def read_policy_meta(directory: str) -> dict:
    """The ``policy.json`` metadata of a checkpoint directory; raises for a foreign one."""
    with open(os.path.join(directory, POLICY_META)) as f:
        meta = json.load(f)
    if meta.get("format") != _FORMAT:
        raise ValueError(
            f"{directory!r} is not a {_FORMAT} checkpoint "
            f"(format={meta.get('format')!r})"
        )
    return meta


def load_policy(directory: str, seed: Optional[int] = None,
                device=None) -> Tuple[Any, Any, TrainState]:
    """Restore ``(env, system, train_state)`` from a policy checkpoint onto ``device``.

    The (env, system) pair is rebuilt from the port's registries with the
    recorded names and overrides, so the restored `TrainState` has the
    structure the system's ``init_train`` gives.  For a per-seed
    checkpoint ``seed`` picks the lane (default 0).  ``device`` defaults
    to CUDA and raises when there is none.
    """
    from repro_torch.systems.registry import make_pair

    device = resolve_device(device)
    meta = read_policy_meta(directory)
    ckpt_dir = directory
    if meta.get("num_seeds"):
        seed = 0 if seed is None else seed
        if not 0 <= seed < meta["num_seeds"]:
            raise ValueError(
                f"seed {seed} out of range for a {meta['num_seeds']}-seed checkpoint"
            )
        ckpt_dir = os.path.join(directory, f"seed_{seed}")
    elif seed not in (None, 0):
        raise ValueError(f"{directory!r} is a single-seed checkpoint")

    overrides = _tupled(meta.get("config_overrides", {}))
    env_kwargs = meta.get("env_kwargs") or None
    env, system = make_pair(meta["system"], meta["env"], env_kwargs=env_kwargs, **overrides)
    target = system.init_train(torch.Generator(device).manual_seed(0))
    if meta.get("tree") == "params":
        params = restore_checkpoint(ckpt_dir, meta["step"], target.params)
        steps = (torch.zeros_like(target.steps) if isinstance(target.steps, torch.Tensor)
                 else 0)
        train = TrainState(params=params, target_params=params, opt_state=target.opt_state,
                           steps=steps)
    else:
        train = restore_checkpoint(ckpt_dir, meta["step"], target)
    return env, system, train


def fresh_system_state(system, train: TrainState, generator, num_envs: int) -> SystemState:
    """A fresh `SystemState` carrying a restored trainer.

    Envs, dataset and carry start anew (new episodes, an empty dataset,
    zero memory) on ``generator``'s device while the trainer resumes from
    the checkpoint: ready for any runner or for more training.
    """
    st = init_system_state(system, generator, num_envs)
    return st._replace(train=train)


def _jsonable(obj):
    """Tuples -> lists, scalars passed through (json round-trip safety)."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [_jsonable(v) for v in obj]
    return obj


def _tupled(obj):
    """Lists -> tuples on the way back in (configs declare tuple fields)."""
    if isinstance(obj, dict):
        return {k: _tupled(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return tuple(_tupled(v) for v in obj)
    return obj
